"""Port vs reference: LM training (``repro_torch.data``, ``optim``,
``train.step``, ``train.trainer``, ``launch.train``) against ``repro``'s
run live on shared data, parameters and gradients.

``TokenStream`` batches are byte-equal.  The schedule, ``init`` and one
AdamW ``update`` on shared gradients agree at rtol 1e-6, fp32 and bf16
parameters.  One step's loss and every gradient leaf agree for all six
families (fp32 compute), each leaf within 4x the reference's own
one-ulp sensitivity (``_lm_parity.ulp_noisy``: the gradient moves that
far when every weight moves by one ulp).  The microbatched step, five
``Trainer`` steps and a resume from the reference's own checkpoint
replay the reference's losses; the reference's training, preemption and
lifecycle tests run on the port.
"""
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as ref_data
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.train import Trainer as RefTrainer
from repro.train import make_train_step as ref_make_train_step
from repro.train import step as ref_step
from repro_torch import data
from repro_torch.common.params import (params_from_numpy, tree_leaves,
                                       tree_map)
from repro_torch.configs import (SHAPES, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.optim import adamw, compression
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import Trainer, init_state, make_train_step
from repro_torch.train import step as pstep

import _lm_parity as P
from _port_share import default_torch_threads, port_share  # noqa: F401

FAMILIES = ["smollm-360m", "pixtral-12b", "moonshot-v1-16b-a3b",
            "zamba2-7b", "rwkv6-1.6b", "whisper-tiny"]
quiet = lambda *_: None


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (7, 5), (0, 10**6),
                                       (11, 4095)])
def test_token_stream_is_byte_equal(seed, step):
    """Step 10**6 keys Philox past 2**32."""
    ref = ref_data.TokenStream(1000, 4, 33, seed=seed).batch_at(step)
    got = data.TokenStream(1000, 4, 33, seed=seed).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == ref[k].dtype == np.int32
        assert got[k].tobytes() == ref[k].tobytes()


def test_stream_iterate_make_stream_and_shard_batch():
    s = data.TokenStream(1000, 2, 16, seed=0)
    assert next(s.iterate(5))["tokens"].tobytes() == \
        s.batch_at(5)["tokens"].tobytes()
    cfg = get_smoke_config("smollm-360m")
    st = data.make_stream(cfg, SHAPES["train_4k"], seed=2, batch_override=3)
    assert (st.vocab_size, st.global_batch, st.seq_len, st.seed) == \
        (cfg.vocab_size, 3, 4096, 2)
    batch = s.batch_at(0)
    placed = data.shard_batch(batch, {"tokens": "cpu", "labels": "cpu"})
    assert all(placed[k].device.type == "cpu"
               and placed[k].dtype == torch.int32 for k in placed)
    assert placed["labels"].numpy().tobytes() == batch["labels"].tobytes()


# -- optimizer -----------------------------------------------------------------

def test_lr_schedule_matches_reference():
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=10, total_steps=100)
    rtc = RefTrainConfig(learning_rate=1e-2, warmup_steps=10, total_steps=100)
    for s in range(121):
        got = float(adamw.lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
        want = float(ref_adamw.lr_schedule(rtc, jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0.0), s


def _tree(rng):
    """A parameter-shaped tree of numpy fp32 leaves whose insertion order
    is not sorted."""
    shapes = {"w": (8, 6), "b": (6,), "layers": {"z": (3, 4, 4), "a": (4,)}}
    return {k: ({kk: rng.standard_normal(vv).astype(np.float32)
                 for kk, vv in v.items()} if isinstance(v, dict)
                else rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


def _to_port(tree, dtype):
    return tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _to_ref(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree,
                        is_leaf=lambda x: isinstance(x, np.ndarray))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_adamw_init_and_update_on_shared_gradients(pdtype):
    """The clip bites (norm ~ 30 > 1) and the moments and step start
    nonzero (step 3), so every term of the update is exercised.  rtol
    1e-6, plus one fp32 ulp of each leaf's largest value."""
    rng = np.random.default_rng(4)
    tdt, jdt = getattr(torch, pdtype), getattr(jnp, pdtype)
    p_np, g_np = _tree(rng), _tree(rng)
    mu_np = tree_map(lambda a: 0.1 * a, _tree(rng))
    nu_np = tree_map(lambda a: 0.01 * a * a, _tree(rng))
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=50)
    rtc = RefTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=50)

    params = _to_port(p_np, tdt)
    opt = adamw.init(params)
    ref_opt = ref_adamw.init(_to_ref(p_np, jdt))
    assert opt["step"].dtype == torch.int32 and opt["step"].ndim == 0
    for got, want in zip(tree_leaves(opt["mu"]), jax.tree.leaves(
            ref_opt["mu"])):
        assert got.dtype == torch.float32 and not got.any()
        assert tuple(got.shape) == want.shape

    opt = {"mu": _to_port(mu_np, torch.float32),
           "nu": _to_port(nu_np, torch.float32),
           "step": torch.tensor(3, dtype=torch.int32)}
    ref_opt = {"mu": _to_ref(mu_np, jnp.float32),
               "nu": _to_ref(nu_np, jnp.float32),
               "step": jnp.asarray(3, jnp.int32)}
    new_p, new_opt, m = adamw.update(_to_port(g_np, tdt), opt, params, tc)
    ref_p, ref_new, rm = ref_adamw.update(_to_ref(g_np, jdt), ref_opt,
                                          _to_ref(p_np, jdt), rtc)
    assert int(new_opt["step"]) == 4 and new_opt["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-6)
    assert float(m["grad_norm"]) > tc.grad_clip
    for got_t, want_t in ((new_p, ref_p), (new_opt["mu"], ref_new["mu"]),
                          (new_opt["nu"], ref_new["nu"])):
        for got, want in zip(tree_leaves(got_t), jax.tree.leaves(want_t)):
            assert str(got.dtype).removeprefix("torch.") == \
                jnp.dtype(want.dtype).name
            # where p - lr * delta cancels, one ulp of the operands
            # (the norm sums in another order) is more than 1e-6 of the
            # result: plus one fp32 ulp of the leaf's largest value
            want = _np(want)
            np.testing.assert_allclose(
                _np(got), want, rtol=1e-6,
                atol=2.0 ** -23 * float(np.abs(want).max()))
    # the inputs are left as they were
    assert not opt["mu"]["w"].equal(new_opt["mu"]["w"])
    assert params["w"].float().numpy().tobytes() == \
        _to_port(p_np, tdt)["w"].float().numpy().tobytes()


def test_adamw_clip_and_schedule():
    """The reference's test_adamw_clip_and_schedule on the port."""
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=10, total_steps=100,
                     grad_clip=1.0)
    lr = lambda s: float(adamw.lr_schedule(tc, torch.tensor(s)))
    assert lr(0) == 0.0
    assert 0 < lr(5) < lr(10) <= 1e-2 + 1e-9
    lrs = [lr(s) for s in range(10, 100, 10)]
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))
    clipped, gnorm = adamw.clip_by_global_norm(
        {"a": torch.full((10,), 100.0)}, 1.0)
    assert float(adamw.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(gnorm) > 1.0


# -- compression ---------------------------------------------------------------

def test_int8_codes_and_topk_masks_equal_the_reference():
    rng = np.random.default_rng(5)
    g = rng.standard_normal(4096).astype(np.float32)
    # exact half-steps of the quantizer: round half to even on both sides
    g[:8] = (np.arange(8) + 0.5) * (np.abs(g).max() / 127.0)
    for x in (g, 1e-3 * g, np.zeros(16, np.float32)):
        q, s = compression.int8_encode(torch.from_numpy(x))
        rq, rs = ref_comp.int8_encode(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert q.numpy().tobytes() == np.asarray(rq).tobytes()
        assert float(s) == pytest.approx(float(rs), rel=1e-7)
        np.testing.assert_allclose(
            compression.int8_decode(q, s).numpy(),
            np.asarray(ref_comp.int8_decode(rq, rs)), rtol=1e-6)
    ties = np.asarray([0.1, -5.0, 0.2, 3.0, -3.0, -0.05], np.float32)
    for x, frac in ((g, 0.05), (g, 0.3), (ties, 0.4), (ties, 0.2)):
        got = compression.topk_mask(torch.from_numpy(x), frac).numpy()
        assert got.tobytes() == np.asarray(
            ref_comp.topk_mask(jnp.asarray(x), frac)).tobytes()
    # ties at the threshold are kept: 3.0 and -3.0 with k = 2
    assert compression.topk_mask(torch.from_numpy(ties), 0.4).sum() == 3


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_error_feedback_telescopes_and_matches_reference(method):
    rng = np.random.default_rng(6)
    grads = [0.1 * rng.standard_normal(64).astype(np.float32)
             for _ in range(20)]
    err = torch.zeros(64)
    ref_err = jnp.zeros((64,))
    sent = torch.zeros(64)
    for g in grads:
        dec, err = compression.compress_leaf(torch.from_numpy(g), err,
                                             method, topk_fraction=0.1)
        rdec, ref_err = ref_comp.compress_leaf(jnp.asarray(g), ref_err,
                                               method, topk_fraction=0.1)
        np.testing.assert_allclose(dec.numpy(), np.asarray(rdec), rtol=1e-6,
                                   atol=1e-7)
        sent = sent + dec
    np.testing.assert_allclose((sent + err).numpy(), sum(grads), rtol=1e-4,
                               atol=1e-5)
    params = {"a": torch.ones(8, 8), "b": torch.ones(4)}
    e0 = compression.init_error_state(params)
    g = tree_map(lambda p: p * 0.01, params)
    dec, new_err = compression.compress_grads(g, e0, method, 0.5)
    assert sorted(dec) == sorted(new_err) == ["a", "b"]
    for k in params:
        assert new_err[k].dtype == torch.float32
        np.testing.assert_allclose((dec[k] + new_err[k]).numpy(),
                                   g[k].numpy(), rtol=1e-6)


# -- the loss and one step's gradients -----------------------------------------

def test_chunked_cross_entropy_with_padded_tail_and_unlabelled_tokens():
    rng = np.random.default_rng(8)
    b, s, d, v, chunk = 2, 21, 8, 11, 8  # 21 = 2 chunks + a padded tail
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    y[0, 3] = y[1, -4:] = -1
    want, want_g = jax.value_and_grad(
        lambda hh: ref_step.chunked_cross_entropy(
            lambda x: x @ jnp.asarray(w), hh, jnp.asarray(y), chunk))(
        jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    got = pstep.chunked_cross_entropy(lambda x: x @ torch.from_numpy(w), ht,
                                      torch.from_numpy(y), chunk)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)
    with torch.no_grad():  # the eager path, no checkpoint
        assert float(pstep.chunked_cross_entropy(
            lambda x: x @ torch.from_numpy(w), ht, torch.from_numpy(y),
            chunk)) == float(got)


def _lm_batch(cfg, rng) -> dict:
    """The shared inputs plus labels, a few of them -1."""
    b = P.draw_inputs(cfg, rng)
    b["labels"] = rng.integers(0, cfg.vocab_size,
                               b["tokens"].shape).astype(np.int32)
    b["labels"][0, -3:] = -1
    return b


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_step_loss_and_gradients_match_reference(arch):
    """fp32 compute.  The loss at rtol 1e-5; each gradient leaf's largest
    error over its largest |g| within 4x the reference's own one-ulp
    sensitivity of that leaf (the same ratio, plus 1e-6 for leaves the
    noise does not move)."""
    cfg, _, m, rm, params, rp = P.pair(arch)
    inputs = _lm_batch(cfg, np.random.default_rng(11))
    rb = {k: jnp.asarray(v) for k, v in inputs.items()}
    vg = jax.jit(jax.value_and_grad(ref_step.make_loss_fn(rm), has_aux=True))
    (r_loss, r_met), r_g = vg(rp, rb)
    _, n_g = vg(P.ulp_noisy(rp), rb)
    (loss, met), g = pstep._value_and_grad(pstep.make_loss_fn(m), params,
                                           P.port_batch(inputs))
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-5)
    assert sorted(met) == sorted(r_met)
    for k in met:
        assert float(met[k]) == pytest.approx(float(r_met[k]), rel=1e-5,
                                              abs=1e-7), k
    named = jax.tree_util.tree_leaves_with_path(r_g)
    assert len(named) == len(tree_leaves(g))
    for (path, want), moved, got in zip(named, jax.tree.leaves(n_g),
                                        tree_leaves(g)):
        want, moved = np.asarray(want), np.asarray(moved)
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got.numpy() - want).max()) / scale
        sens = float(np.abs(moved - want).max()) / scale
        assert err <= 4 * sens + 1e-6, (
            arch, jax.tree_util.keystr(path), err, sens)


@pytest.mark.usefixtures("default_torch_threads")
def test_reference_init_gradient_grows_with_depth_in_both_packages():
    """The schema's ``scaled`` init takes the head count as the attention
    projections' fan-in, so at smollm-360m's width (6 layers, vocabulary
    cut to 512) each layer toward the input multiplies the gradient: the
    first layer's norm is over 1000x the last's, in the reference and in
    the port on the same weights (each layer within 25%: the stack is
    chaotic, so the port runs at the process's own torch thread count, the
    one this was measured at; on one thread the first layer's norm is 2.6x
    the reference's).  ``chip_smoke.py`` phase 9 (a) trains from re-drawn
    weights for this reason."""
    kw = dict(num_layers=6, compute_dtype="float32", vocab_size=512)
    ref_m = ref_get_model(ref_get_config("smollm-360m").replace(**kw))
    rp = ref_m.init(jax.random.PRNGKey(0))
    m = get_model(get_config("smollm-360m").replace(**kw))
    params = params_from_numpy(m.schema(), jax.tree.map(np.asarray, rp),
                               "cpu")
    batch = data.TokenStream(512, 1, 64).batch_at(0)
    _, r_g = jax.jit(jax.value_and_grad(ref_step.make_loss_fn(ref_m),
                                        has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, g = pstep._value_and_grad(pstep.make_loss_fn(m), params,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})

    def per_layer(leaves):
        return np.sqrt(sum(np.sum(np.asarray(x, np.float64).reshape(6, -1)
                                  ** 2, axis=1) for x in leaves))

    want = per_layer(jax.tree.leaves(r_g["layers"]))
    got = per_layer([x.numpy() for x in tree_leaves(g["layers"])])
    assert want[0] > 1000 * want[-1] and got[0] > 1000 * got[-1]
    np.testing.assert_allclose(got, want, rtol=0.25)


def _smoke(arch="smollm-360m"):
    cfg, _, m, rm, params, rp = P.pair(arch)
    return m, rm, params, rp


def _ref_state_np(rm, rp):
    state = {"params": rp, "opt": ref_adamw.init(rp)}
    return jax.tree.map(np.asarray, state)


def _port_state(m, state_np):
    return {"params": params_from_numpy(m.schema(), state_np["params"],
                                        "cpu"),
            "opt": tree_map(lambda a: torch.from_numpy(np.array(a)),
                            state_np["opt"])}


def test_microbatched_step_matches_reference_and_single_batch():
    """The reference's test_microbatch_equivalence on the port, and the
    port's 4-microbatch step against the reference's on the same state:
    loss and metrics at rtol 1e-5 (the gradient norm 1e-4), parameters at
    the reference test's rtol 2e-4 / atol 2e-5."""
    m, rm, params, rp = _smoke()
    stream = data.TokenStream(m.cfg.vocab_size, 8, 32, seed=0)
    batch = stream.batch_at(0)
    state_np = _ref_state_np(rm, rp)
    out4, m4 = ref_make_train_step(rm, RefTrainConfig(microbatches=4))(
        jax.tree.map(jnp.asarray, state_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p1, g1 = make_train_step(m, TrainConfig(microbatches=1))(
        _port_state(m, state_np), tb)
    p4, g4 = make_train_step(m, TrainConfig(microbatches=4))(
        _port_state(m, state_np), tb)
    assert sorted(g4) == sorted(m4)
    for k in m4:
        # the reference's own grad norm moves by 6.2e-5 of itself when
        # every weight moves by one ulp (_lm_parity.ulp_noisy), so it is
        # held at 1e-4
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert float(g4[k]) == pytest.approx(float(m4[k]), rel=rel), k
    assert float(g1["loss"]) == pytest.approx(float(g4["loss"]), rel=1e-5)
    for a, b, r in zip(tree_leaves(p4["params"]), tree_leaves(p1["params"]),
                       jax.tree.leaves(out4["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    assert int(p4["opt"]["step"]) == 1
    with pytest.raises(AssertionError, match="not divisible"):
        make_train_step(m, TrainConfig(microbatches=3))(
            _port_state(m, state_np), tb)


# -- the trainer ---------------------------------------------------------------

def _ref_trainer_losses(rm, rp, tc, stream, n):
    tr = RefTrainer(rm, tc, stream)
    state = jax.tree.map(jnp.asarray, _ref_state_np(rm, rp))
    _, _, hist = tr.run(state, 0, n, log_fn=quiet)
    return [float(h["loss"]) for h in hist]


def test_five_trainer_steps_from_a_shared_state_match_reference():
    m, rm, params, rp = _smoke("qwen1.5-0.5b")
    tc = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    ref = ref_data.TokenStream(m.cfg.vocab_size, 4, 32, seed=7)
    want = _ref_trainer_losses(rm, rp, RefTrainConfig(**tc), ref, 5)
    tr = Trainer(m, TrainConfig(**tc),
                 data.TokenStream(m.cfg.vocab_size, 4, 32, seed=7),
                 device="cpu")
    _, end, hist = tr.run(_port_state(m, _ref_state_np(rm, rp)), 0, 5,
                          log_fn=quiet)
    assert end == 5 and len(tr.step_times) == 5
    assert sorted(hist[0]) == ["ce", "grad_norm", "loss", "lr"]
    np.testing.assert_allclose([float(h["loss"]) for h in hist], want,
                               rtol=1e-4)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's Trainer checkpoints at step 3; the port's Trainer
    resumes from that directory, and its next 2 losses equal the
    reference's own continuation."""
    m, rm, params, rp = _smoke()
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    kw = dict(learning_rate=2e-3, warmup_steps=2, total_steps=20,
              checkpoint_every=3, async_checkpoint=False)
    stream_args = (m.cfg.vocab_size, 4, 32, 1)
    rtc = RefTrainConfig(checkpoint_dir=str(ref_dir), **kw)
    tr = RefTrainer(rm, rtc, ref_data.TokenStream(*stream_args))
    state, start = tr.init_or_resume()
    tr.run(state, start, 3, log_fn=quiet)
    shutil.copytree(ref_dir, port_dir)
    tr2 = RefTrainer(rm, rtc, ref_data.TokenStream(*stream_args))
    state, start = tr2.init_or_resume()
    assert start == 3
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(state)]
    _, _, want = tr2.run(state, start, 2, log_fn=quiet)  # donates state

    ptr = Trainer(m, TrainConfig(checkpoint_dir=str(port_dir), **kw),
                  data.TokenStream(*stream_args), device="cpu")
    pstate, pstart = ptr.init_or_resume()
    assert pstart == 3 and int(pstate["opt"]["step"]) == 3
    for got, ref in zip(tree_leaves(pstate), ref_leaves):
        assert got.numpy().tobytes() == ref.tobytes()
    _, end, got = ptr.run(pstate, pstart, 2, log_fn=quiet)
    assert end == 5 and ptr.ckpt.latest_step() == 5
    np.testing.assert_allclose([float(h["loss"]) for h in got],
                               [float(h["loss"]) for h in want], rtol=1e-4)


def _setup(arch="smollm-360m"):
    cfg = get_smoke_config(arch)
    return get_model(cfg), data.TokenStream(cfg.vocab_size, 8, 32, seed=0)


def test_loss_decreases():
    """The reference's test_loss_decreases on the port."""
    model, stream = _setup()
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=5, total_steps=100)
    tr = Trainer(model, tc, stream, device="cpu")
    state, start = tr.init_or_resume()
    state, end, hist = tr.run(state, start, 30, log_every=1000,
                              log_fn=quiet)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_preemption_checkpoint(tmp_path):
    """The reference's test_preemption_checkpoint on the port."""
    model, stream = _setup()
    tc = TrainConfig(learning_rate=1e-3, checkpoint_dir=str(tmp_path),
                     checkpoint_every=1000, async_checkpoint=False)
    tr = Trainer(model, tc, stream, device="cpu")
    state, start = tr.init_or_resume()
    tr._preempted = True  # simulate SIGTERM mid-run
    state, next_step, hist = tr.run(state, start, 10, log_fn=quiet)
    assert next_step == 1  # stopped after first step
    assert tr.ckpt.latest_step() == 1
    tr2 = Trainer(model, tc, stream, device="cpu")
    state2, start2 = tr2.init_or_resume()
    assert start2 == 1
    for a, b in zip(tree_leaves(state), tree_leaves(state2)):
        assert a.equal(b)


def test_sharded_training_is_not_ported(capsys):
    """Sharded training, which raised NotImplementedError here before the
    LM sharding rules were ported, now runs: shardings without their mesh
    raise, a mesh larger than the group raises (and the launcher leaves no
    group behind), and ``--mesh 1x1`` on a one-rank gloo group trains to
    the unsharded launcher's losses."""
    import torch.distributed as dist

    model, stream = _setup()
    with pytest.raises(ValueError, match="mesh"):
        Trainer(model, TrainConfig(), stream, state_shardings={},
                device="cpu")
    argv = ["--arch", "smollm-360m", "--steps", "3", "--device", "cpu"]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        launch_train.main(argv + ["--mesh", "2x1"])
    assert not dist.is_initialized()
    capsys.readouterr()
    launch_train.main(argv)
    plain = capsys.readouterr().out.strip().splitlines()[-1]
    launch_train.main(argv + ["--mesh", "1x1"])
    sharded = capsys.readouterr().out.strip().splitlines()[-1]
    assert not dist.is_initialized()
    assert plain.startswith("done: steps 0..3") and sharded == plain


def test_train_checkpoint_resume_serve(tmp_path):
    """tests/test_system.py's lifecycle on the port: train 12 steps
    (checkpoint at 10), a fresh Trainer resumes, 5 more steps, serve the
    trained parameters."""
    cfg = get_smoke_config("smollm-360m")
    model = get_model(cfg)
    stream = data.TokenStream(cfg.vocab_size, 8, 32, seed=0)
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=5, total_steps=50,
                     checkpoint_dir=str(tmp_path), checkpoint_every=10,
                     async_checkpoint=False)
    tr = Trainer(model, tc, stream, device="cpu")
    state, start = tr.init_or_resume()
    state, nxt, _ = tr.run(state, start, 12, log_fn=quiet)
    tr2 = Trainer(model, tc, stream, device="cpu")
    state2, start2 = tr2.init_or_resume()
    assert start2 in (10, 12)
    state2, _, hist2 = tr2.run(state2, start2, 5, log_fn=quiet)
    assert np.isfinite([h["loss"] for h in hist2]).all()
    engine = ServeEngine(model, state2["params"], batch_size=2, max_len=64,
                         device="cpu")
    out = engine.generate([Request(prompt=np.arange(6, dtype=np.int32),
                                   max_new_tokens=4)])
    assert len(out[0].out_tokens) == 4
    assert all(0 <= t < cfg.vocab_size for t in out[0].out_tokens)


def test_deterministic_training_replay():
    """tests/test_system.py's replay on the port: two trainers over the
    same stream and seed give identical losses."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = get_model(cfg)
    stream = data.TokenStream(cfg.vocab_size, 4, 32, seed=7)

    def run():
        tr = Trainer(model, TrainConfig(learning_rate=1e-3), stream,
                     device="cpu")
        state, _ = tr.init_or_resume(seed=5)
        _, _, hist = tr.run(state, 0, 5, log_fn=quiet)
        return [float(h["loss"]) for h in hist]

    assert run() == run()


def test_init_state_and_extra_batch():
    """``init_state`` draws on the generator's device; ``extra_batch``
    adds whisper's stub frames to every step."""
    cfg = get_smoke_config("whisper-tiny")
    model = get_model(cfg)
    st = init_state(model, torch.Generator().manual_seed(0))
    assert sorted(st) == ["opt", "params"]
    assert sorted(st["opt"]) == ["mu", "nu", "step"]
    frames = lambda step: {"audio_embeds": np.zeros(
        (4, cfg.enc_ctx, cfg.d_model), np.float32)}
    tr = Trainer(model, TrainConfig(), data.TokenStream(cfg.vocab_size, 4,
                                                       16),
                 extra_batch=frames, device="cpu")
    _, end, hist = tr.run(st, 0, 2, log_fn=quiet)
    assert end == 2 and np.isfinite([h["loss"] for h in hist]).all()


def test_train_launcher(tmp_path, capsys):
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                signal.SIGINT)}
    try:
        args = ["--arch", "smollm-360m", "--steps", "3", "--batch", "4",
                "--seq", "16", "--checkpoint-dir", str(tmp_path),
                "--device", "cpu"]
        launch_train.main(args)
        assert "done: steps 0..3" in capsys.readouterr().out
        launch_train.main(args)  # resumes at the final checkpoint
        assert "done: steps 3..6" in capsys.readouterr().out
    finally:
        for s, h in before.items():
            signal.signal(s, h)
