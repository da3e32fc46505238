"""Shared set-up of the LM model-zoo parity tests
(``test_torch_models.py``, ``test_torch_models_recurrent.py``): each
arch's smoke config built in both packages, the reference's parameters
from ``Model.init(PRNGKey(0))`` carried to the port through numpy, inputs
drawn with numpy from a seed, and the reference's forward, prefill and
decode computed once per (arch, compute dtype) and shared by every test.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import get_model as ref_get_model
from repro_torch.common.params import params_from_numpy, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model

B, S, MAX_LEN = 2, 17, 32
SEED = 7

# fp32 tolerance: |port - ref| <= RTOL |ref| + ATOL x max |ref|.  Three
# archs get more atol, by the reference's own conditioning
# (ulp_sensitivity): one ulp of noise on its weights moves its forward
# logits by 1.8e-5 (pixtral-12b, the 1024-wide stub image embeddings
# projected in), 3.0e-5 (zamba2-7b, the SSM state through five layers)
# and 3.0e-5 (whisper-tiny, the encoder output through two LayerNorms and
# a cross-attention) of their largest value
RTOL, ATOL = 1e-4, 1e-5
ATOL_BY_ARCH = {"pixtral-12b": 5e-5, "zamba2-7b": 5e-5, "whisper-tiny": 1e-4}


def atol(arch: str) -> float:
    return ATOL_BY_ARCH.get(arch, ATOL)


@dataclasses.dataclass
class Case:
    arch: str
    cfg: object  # the port's config
    ref_cfg: object
    model: object
    ref_model: object
    params: dict  # the port's tensors on the CPU
    ref_params: dict
    inputs: dict  # numpy
    token: np.ndarray  # (B, 1) the decode step's token
    ref: dict  # numpy: forward, prefill, prefill_cache, decode, decode_cache


def port_batch(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def draw_inputs(cfg, rng) -> dict:
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, 1024)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return out


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)
                                             if x.dtype == jnp.bfloat16
                                             else x), tree)


@functools.lru_cache(maxsize=None)
def pair(arch: str, compute: str = "float32") -> tuple:
    """(port config, reference config, port model, reference model, the
    port's CPU tensors, the reference's parameters from PRNGKey(0))."""
    ref_cfg = ref_smoke(arch).replace(compute_dtype=compute)
    cfg = get_smoke_config(arch).replace(compute_dtype=compute)
    rm, m = ref_get_model(ref_cfg), get_model(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(m.schema(), jax.tree.map(np.asarray, rp),
                               "cpu")
    return cfg, ref_cfg, m, rm, params, rp


@functools.lru_cache(maxsize=None)
def case(arch: str, compute: str = "float32") -> Case:
    cfg, ref_cfg, m, rm, params, rp = pair(arch, compute)
    rng = np.random.default_rng(SEED)
    inputs = draw_inputs(cfg, rng)
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    rb = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref = {"forward": _np(rm.forward(rp, rb)[0])}
    logits, cache = rm.prefill(rp, rb, rm.init_cache(B, MAX_LEN))
    ref["prefill"], ref["prefill_cache"] = _np(logits), _np(cache)
    logits, cache = rm.decode_step(rp, jnp.asarray(token), cache)
    ref["decode"], ref["decode_cache"] = _np(logits), _np(cache)
    ref["cache_dtypes"] = {k: jnp.dtype(v.dtype).name
                           for k, v in cache.items()}
    return Case(arch, cfg, ref_cfg, m, rm, params, rp, inputs, token, ref)


def port_outputs(c: Case) -> dict:
    """The port's forward, prefill and decode on the case's inputs, each
    cache snapshotted (the port writes its cache in place)."""
    with torch.no_grad():
        b = port_batch(c.inputs)
        out = {"forward": c.model.forward(c.params, b)[0]}
        cache = c.model.init_cache(B, MAX_LEN, device="cpu")
        logits, cache = c.model.prefill(c.params, b, cache)
        out["prefill"] = logits
        out["prefill_cache"] = {k: v.clone() for k, v in cache.items()}
        logits, cache = c.model.decode_step(
            c.params, torch.from_numpy(c.token), cache)
        out["decode"], out["decode_cache"] = logits, cache
    return out


def assert_close(got: torch.Tensor, want: np.ndarray, rtol: float,
                 atol_frac: float, what: str) -> float:
    """|got - want| <= rtol |want| + atol_frac x max |want|, elementwise;
    returns the largest error over max |want|."""
    g = got.detach().float().numpy()
    assert g.shape == want.shape, (what, g.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = np.abs(g - want)
    bad = err > rtol * np.abs(want) + atol_frac * scale
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} elements off; max error "
        f"{float(err.max()):.3g} at scale {scale:.3g}")
    return float(err.max()) / scale


def cache_dtypes(cache: dict) -> dict:
    return {k: str(v.dtype).removeprefix("torch.") for k, v in cache.items()}


def check_fp32(c: Case, which: str) -> None:
    """Logits and (for prefill / decode) every cache leaf against the
    reference at the fp32 tolerance."""
    out = port_outputs(c)
    a = atol(c.arch)
    assert_close(out[which], c.ref[which], RTOL, a, f"{c.arch} {which}")
    if which == "forward":
        return
    got, want = out[f"{which}_cache"], c.ref[f"{which}_cache"]
    assert sorted(got) == sorted(want)
    assert cache_dtypes(got) == c.ref["cache_dtypes"]
    for key in sorted(want):
        if key == "pos":
            assert int(got[key]) == int(want[key]) and got[key].ndim == 0
            continue
        assert_close(got[key], want[key], RTOL, a, f"{c.arch} {which} {key}")


def ulp_noisy(ref_params):
    """The reference's fp32 parameters, every weight moved by one ulp (a
    seeded sign each)."""
    rng = np.random.default_rng(2)
    return jax.tree.map(
        lambda t: jnp.asarray((np.asarray(t) * (1 + 2.0 ** -23 * np.sign(
            rng.standard_normal(t.shape)))).astype(np.float32)),
        ref_params)


def ulp_sensitivity(c: Case) -> float:
    """How far the reference's own fp32 forward logits move, over their
    largest value, when every weight moves by one ulp (a seeded sign
    each): the error any other fp32 rounding of the same model may
    show."""
    rb = {k: jnp.asarray(v) for k, v in c.inputs.items()}
    moved = np.asarray(c.ref_model.forward(ulp_noisy(c.ref_params), rb)[0])
    want = c.ref["forward"]
    return float(np.abs(moved - want).max() / np.abs(want).max())


def check_within_conditioning(arch: str) -> None:
    """The port's fp32 forward logits sit within 4x the reference's own
    one-ulp sensitivity of the reference's, every arch alike."""
    c = case(arch)
    out = port_outputs(c)["forward"].numpy()
    want = c.ref["forward"]
    err = float(np.abs(out - want).max() / np.abs(want).max())
    assert err <= 4 * ulp_sensitivity(c), (arch, err)


# bf16 compute: XLA:CPU and torch round bf16 intermediates differently
# (and a near-tie of the MoE router may flip), so the two bf16 results
# differ by the size of bf16's own error.  Held: (1) the port's bf16
# forward logits are no further from the reference's fp32 ones (RMS,
# relative) than BF16_BUDGET x the reference's own bf16 logits are; (2)
# the port's bf16 forward, prefill and decode logits within a relative
# RMS of BF16_RMS of the reference's bf16 ones; more for the two archs
# whose bf16 logits the reference itself moves by 9-27% RMS from fp32.
BF16_BUDGET = 1.25
BF16_RMS = 0.1
BF16_RMS_BY_ARCH = {"whisper-tiny": 0.2, "zamba2-7b": 0.2}


def _rel_rms(d: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean(d ** 2) / np.mean(ref ** 2)))


def check_bf16(arch: str) -> None:
    c, c32 = case(arch, "bfloat16"), case(arch)
    out = port_outputs(c)
    f32 = c32.ref["forward"]
    ref_err = _rel_rms(c.ref["forward"] - f32, f32)
    port_err = _rel_rms(out["forward"].float().numpy() - f32, f32)
    assert port_err <= BF16_BUDGET * ref_err, (arch, port_err, ref_err)
    for which in ("forward", "prefill", "decode"):
        assert out[which].dtype == torch.bfloat16
        err = _rel_rms(out[which].float().numpy() - c.ref[which],
                       c.ref[which])
        assert err <= BF16_RMS_BY_ARCH.get(arch, BF16_RMS), (arch, which, err)
    assert cache_dtypes(out["decode_cache"]) == c.ref["cache_dtypes"]


def consistency_error(model, params, inputs: dict) -> float:
    """The reference test's check on the port: decode(prefill(t[:-1]),
    t[-1]) against prefill(t)'s last logits, err / scale."""
    with torch.no_grad():
        b = dict(inputs)
        full, _ = model.prefill(params, b,
                                model.init_cache(B, 64, device="cpu"))
        pre = dict(b, tokens=b["tokens"][:, :-1])
        _, cache = model.prefill(params, pre,
                                 model.init_cache(B, 64, device="cpu"))
        dec, _ = model.decode_step(params, b["tokens"][:, -1:], cache)
    err = float((dec[:, 0] - full[:, 0]).abs().max())
    return err / (float(full.abs().max()) + 1e-6)


def gradients(model, params, inputs: dict) -> dict:
    """The reference test_gradients_flow's loss, differentiated by
    autograd: mean(logits^2) + the aux losses."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    logits, aux = model.forward(p, inputs)
    loss = torch.mean(torch.square(logits.float()))
    if aux:
        loss = loss + sum(aux.values())
    loss.backward()
    return tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, p)
