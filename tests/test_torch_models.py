"""Port vs reference: the LM configs and the attention families of the
model zoo (``repro_torch.configs`` and ``repro_torch.models``: layers,
``dense``, ``vlm`` and ``moe``) against ``repro.configs`` /
``repro.models`` run live on the same weights and inputs.

Every config field equals the reference's; the full configs' parameter
counts, taken from the schemas, too.  Forward, prefill and one decode
step's logits and every cache leaf agree at fp32 (``_lm_parity``: rtol
1e-4 plus 1e-5 of the largest |value|), bf16 compute at its own bound.
The MoE dispatch indices are equal exactly, the router's top-k indices
too (or the differing token is a near-tie).  The reference's own checks
(``tests/test_models.py``) run on the port.  The recurrent families are
``tests/test_torch_models_recurrent.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.common import params as ref_params
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.common import params
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import get_model, layers, moe

import _lm_parity as P
from _port_share import port_share  # noqa: F401

ARCHS = ["llama3-8b", "qwen1.5-0.5b", "smollm-360m", "command-r-plus-104b",
         "pixtral-12b", "dbrx-132b", "moonshot-v1-16b-a3b"]
MOE = ["dbrx-132b", "moonshot-v1-16b-a3b"]


# -- configs -----------------------------------------------------------------

def _fields_equal(a, b):
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for n in names:
        assert getattr(a, n) == getattr(b, n), n


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_fields_equal_reference(arch):
    for ref_cfg, cfg in ((ref_configs.get_config(arch),
                          configs.get_config(arch)),
                         (ref_configs.get_smoke_config(arch),
                          configs.get_smoke_config(arch))):
        _fields_equal(ref_cfg, cfg)
        for f in ("attention_free", "subquadratic", "d_inner", "ssm_heads"):
            assert getattr(ref_cfg, f) == getattr(cfg, f), f
        assert str(cfg.dtype()).removeprefix("torch.") == \
            jnp.dtype(ref_cfg.dtype()).name
        assert str(cfg.pdtype()).removeprefix("torch.") == \
            jnp.dtype(ref_cfg.pdtype()).name
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS


def test_shape_mesh_train_configs_and_dtypes_equal_reference():
    assert list(configs.SHAPES) == list(ref_configs.SHAPES)
    for name, shape in ref_configs.SHAPES.items():
        _fields_equal(shape, configs.SHAPES[name])
    for multi in (False, True):
        a, b = ref_configs.MeshConfig(multi), configs.MeshConfig(multi)
        assert (a.shape, a.axes, a.num_devices) == \
            (b.shape, b.axes, b.num_devices)
    _fields_equal(ref_configs.TrainConfig(), configs.TrainConfig())
    from repro.configs.base import DTYPES as REF_DTYPES
    assert {k: jnp.dtype(v).name for k, v in REF_DTYPES.items()} == \
        {k: str(v).removeprefix("torch.")
         for k, v in configs.base.DTYPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_applicable_shapes_agree():
    for arch in configs.ARCH_IDS:
        assert configs.applicable_shapes(configs.get_config(arch)) == \
            ref_configs.applicable_shapes(ref_configs.get_config(arch))
    # the reference's test_long_context_applicability
    subq = {a for a in configs.ARCH_IDS
            if "long_500k" in configs.applicable_shapes(configs.get_config(a))}
    assert subq == {"zamba2-7b", "rwkv6-1.6b"}


# -- params --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_full_config_param_counts_equal_reference(arch):
    """Counted from the schema (nothing allocated); the reference's
    test_full_configs_param_counts bounds hold too."""
    from repro.models import get_model as ref_get_model

    sch = get_model(configs.get_config(arch)).schema()
    ref_sch = ref_get_model(ref_configs.get_config(arch)).schema()
    n = params.count_params(sch)
    assert n == ref_params.count_params(ref_sch)
    shapes = params.schema_shapes(sch)
    leaves = params.tree_leaves(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == n
    ref_leaves = jax.tree.leaves(ref_params.schema_shapes(ref_sch))
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(s.shape) for s in ref_leaves]
    assert [str(t.dtype).removeprefix("torch.") for t in leaves] == \
        [jnp.dtype(s.dtype).name for s in ref_leaves]


def test_schema_helpers_equal_reference():
    cfg, ref_cfg = (configs.get_smoke_config("zamba2-7b"),
                    ref_configs.get_smoke_config("zamba2-7b"))
    from repro.models import get_model as ref_get_model

    sch, ref_sch = get_model(cfg).schema(), ref_get_model(ref_cfg).schema()
    assert params.schema_axes(sch) == ref_params.schema_axes(ref_sch)
    # two-level stacking: (n_super, per, ...) with both logical axes
    conv = sch["super"]["conv_w"]
    assert conv.shape[:2] == (2, 2) and conv.axes[:2] == \
        ("layers", "layers_inner")
    assert params.is_param(conv) and not params.is_param(conv.shape)
    tree = {"w": torch.ones(2, dtype=torch.float32),
            "i": torch.ones(2, dtype=torch.int32)}
    cast = params.cast_floating(tree, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32
    # bf16 arrays cross bit for bit
    x = np.asarray(jnp.asarray([1.0, -2.5, 3e-3], jnp.bfloat16))
    p = params.Param((3,), (None,), dtype=torch.bfloat16)
    t = params.params_from_numpy({"x": p}, {"x": x}, "cpu")["x"]
    assert t.view(torch.int16).numpy().tobytes() == x.tobytes()


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("sk,chunk,valid,causal", [
    (20, 8, None, True),   # padded tail, causal
    (20, 8, 13, False),    # padded tail and kv_valid_len
    (16, 16, 11, True),    # one chunk, kv_valid_len
    (24, 64, None, False),  # chunk clipped to the KV length
])
def test_chunked_attention_matches_reference(sk, chunk, valid, causal):
    rng = np.random.default_rng(sk + chunk)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    qpos = (np.arange(9) + sk - 9).astype(np.int32)
    want = np.asarray(ref_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        chunk_size=chunk, q_positions=jnp.asarray(qpos),
        kv_valid_len=None if valid is None else jnp.asarray(valid)))
    got = layers.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, chunk_size=chunk, q_positions=torch.from_numpy(qpos),
        kv_valid_len=None if valid is None else torch.tensor(valid))
    P.assert_close(got, want, P.RTOL, P.ATOL, "chunked_attention")


def test_decode_attention_and_cache_write_match_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    want = np.asarray(ref_layers.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(6)))
    got = layers.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.tensor(6))
    P.assert_close(got, want, P.RTOL, P.ATOL, "decode_attention")
    # lax.dynamic_update_slice's clamp at a device index and a host one
    new = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    for pos in (0, 4, 11):
        want = np.asarray(jax.lax.dynamic_update_slice(
            jnp.asarray(kc), jnp.asarray(new), (0, pos, 0, 0)))
        for p in (pos, torch.tensor(pos, dtype=torch.int32)):
            buf = torch.from_numpy(kc.copy())
            layers.write_cache(buf, torch.from_numpy(new), p)
            assert np.array_equal(buf.numpy(), want), pos


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_rope_and_mlps_match_reference(norm):
    cfg = configs.get_smoke_config("llama3-8b").replace(norm_type=norm)
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        norm_type=norm)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    P.assert_close(layers.apply_norm(tp, torch.from_numpy(x), cfg),
                   np.asarray(ref_layers.apply_norm(jp, jnp.asarray(x),
                                                    ref_cfg)),
                   P.RTOL, P.ATOL, "apply_norm")
    h = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    P.assert_close(
        layers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos), 5e5),
        np.asarray(ref_layers.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                                         5e5)), P.RTOL, P.ATOL, "apply_rope")
    for gated in (True, False):
        c, rc = cfg.replace(mlp_gated=gated), ref_cfg.replace(mlp_gated=gated)
        ref_p = jax.tree.map(np.asarray, ref_params.init_params(
            ref_layers.mlp_schema(rc), jax.random.PRNGKey(1)))
        ref_p = {k: v + 0.1 for k, v in ref_p.items()}  # nonzero biases
        tp = params.params_from_numpy(layers.mlp_schema(c), ref_p, "cpu")
        P.assert_close(
            layers.mlp_layer(tp, torch.from_numpy(x), c),
            np.asarray(ref_layers.mlp_layer(
                jax.tree.map(jnp.asarray, ref_p), jnp.asarray(x), rc)),
            P.RTOL, P.ATOL, f"mlp gated={gated}")


# -- whole models at fp32 and bf16 ---------------------------------------------

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


def test_get_model_serves_every_arch():
    from repro.models import get_model as ref_get_model

    for arch in configs.ARCH_IDS:
        m = get_model(configs.get_smoke_config(arch))
        rm = ref_get_model(ref_configs.get_smoke_config(arch))
        assert m.module.__name__.rsplit(".", 1)[1] == \
            rm.module.__name__.rsplit(".", 1)[1]
        for kind, seq in (("train", 24), ("prefill", 24), ("decode", 24)):
            shape = ShapeConfig("s", seq, 2, kind)
            want = rm.input_specs(ref_configs.ShapeConfig("s", seq, 2, kind))
            got = m.input_specs(shape)
            assert list(got) == list(want)
            for name, spec in got.items():
                assert spec.device.type == "meta"
                assert tuple(spec.shape) == tuple(want[name].shape)
                assert str(spec.dtype).removeprefix("torch.") == \
                    jnp.dtype(want[name].dtype).name
            gen = torch.Generator().manual_seed(0)
            inputs = m.make_inputs(gen, shape)
            assert {k: (tuple(v.shape), v.dtype, v.device.type)
                    for k, v in inputs.items()} == \
                {k: (tuple(v.shape), v.dtype, "cpu") for k, v in got.items()}
            toks = inputs["tokens"]
            assert int(toks.min()) >= 0 and int(toks.max()) < m.cfg.vocab_size
    with pytest.raises(KeyError, match="unknown family"):
        get_model(configs.get_smoke_config("llama3-8b").replace(family="x"))


# -- MoE dispatch ------------------------------------------------------------

@pytest.mark.parametrize("t,k,e,c", [
    (17, 2, 4, 8),    # training capacity, some experts overflow
    (34, 2, 8, 8),    # overflow on a skewed draw
    (34, 2, 8, 68),   # no-drop (serving) capacity
    (64, 6, 64, 8),   # moonshot-shaped
    (5, 4, 16, 1),    # capacity 1: nearly everything dropped
])
def test_dispatch_indices_equal_reference(t, k, e, c):
    rng = np.random.default_rng(t * e + c)
    # skewed expert choice so that capacities overflow
    pr = np.linspace(1.0, 0.1, e)
    idx = np.stack([rng.choice(e, size=k, replace=False, p=pr / pr.sum())
                    for _ in range(t)]).astype(np.int32)
    st_r, soa_r = ref_moe._dispatch_indices(jnp.asarray(idx), t, k, e, c)
    st, soa = moe._dispatch_indices(torch.from_numpy(idx), t, k, e, c)
    assert np.array_equal(st.numpy(), np.asarray(st_r))
    assert np.array_equal(soa.numpy(), np.asarray(soa_r))
    if c < t * k:
        assert (soa.numpy() == e * c).any() or c * e >= t * k


def test_capacity_equal_reference():
    for arch in MOE:
        for full in (True, False):
            cfg = (configs.get_config if full else
                   configs.get_smoke_config)(arch)
            rcfg = (ref_configs.get_config if full else
                    ref_configs.get_smoke_config)(arch)
            for cf in (None, 1.0, 2.0, 8.0):
                for t in (1, 2, 7, 34, 512, 1365, 1366, 4096, 65536):
                    assert moe.expert_capacity(cfg, t, cf) == \
                        ref_moe.expert_capacity(rcfg, t, cf)
                    for serving in (True, False):
                        assert moe._capacity(cfg, t, serving) == \
                            ref_moe._capacity(rcfg, t, serving)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    gv, gi = jax.lax.top_k(jnp.asarray(probs), 2)
    v, i = moe.top_k(torch.from_numpy(probs), 2)
    assert np.array_equal(i.numpy(), np.asarray(gi))
    assert np.array_equal(v.numpy(), np.asarray(gv))


@pytest.mark.parametrize("arch", MOE)
def test_router_top_k_equals_reference(arch, monkeypatch):
    """Each layer's router input, taken from the port's forward, routed by
    both packages: the indices are equal, or the token is a near-tie
    (the k-th and (k+1)-th probabilities within 1e-6)."""
    c = P.case(arch)
    seen = []
    real = moe.moe_mlp_layer

    def record(p, x, cfg, serving=False, mesh=None):
        seen.append((p["router"], x.detach().reshape(-1, x.shape[-1])))
        return real(p, x, cfg, serving=serving, mesh=mesh)

    monkeypatch.setattr(moe, "moe_mlp_layer", record)
    with torch.no_grad():
        c.model.forward(c.params, P.port_batch(c.inputs))
    assert len(seen) == c.cfg.num_layers
    k = c.cfg.top_k
    for router, xt in seen:
        probs = torch.softmax(xt.float() @ router, dim=-1)
        _, idx = moe.top_k(probs, k)
        rp = jax.nn.softmax(jnp.asarray(xt.numpy()) @ jnp.asarray(
            router.numpy()), axis=-1)
        _, ridx = jax.lax.top_k(rp, k)
        diff = np.nonzero((idx.numpy() != np.asarray(ridx)).any(-1))[0]
        srt = np.sort(np.asarray(rp), axis=-1)[:, ::-1]
        for tok in diff:
            assert srt[tok, k - 1] - srt[tok, k] < 1e-6, (arch, tok)


_MOE_SHARDS = r"""
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model, layers, moe
cfg = configs.get_smoke_config("dbrx-132b")
p = get_model(cfg).init(torch.Generator().manual_seed(0))
lp = layers.layer(p["layers"], 0)["moe"]
x = torch.randn(2, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
taken = []
real = moe._sharded_dispatch
moe._sharded_dispatch = lambda *a: taken.append(1) or real(*a)
with torch.no_grad(), shd.activation_mesh(make_mesh((2, 1), ("data", "model"))):
    y, _ = moe.moe_mlp_layer(lp, x, cfg)
    shard = y.to_local()
with torch.no_grad():
    want, _ = moe.moe_mlp_layer(lp, x[:1], cfg)
print(json.dumps({"taken": len(taken), "shape": list(y.shape),
                  "err": float((shard - want).abs().max())}))
"""


def test_moe_mesh_with_several_data_shards_raises():
    """The reference's shard_map branch, once a NotImplementedError here,
    is ported: on a fake 2-rank group with two data shards, the layer
    takes the sharded dispatch, and rank 0's shard equals the local path
    over its own tokens at the per-shard capacity."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", _MOE_SHARDS],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["taken"] == 1
    assert res["shape"] == [2, 4, configs.get_smoke_config("dbrx-132b").d_model]
    assert res["err"] < 1e-6


# -- the reference's own checks (tests/test_models.py) on the port ------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    c = P.case(arch)
    err = P.consistency_error(c.model, c.params, P.port_batch(c.inputs))
    assert err < 1e-3, f"{arch}: decode/prefill mismatch {err}"


@pytest.mark.parametrize("arch", MOE)
def test_moe_nodrop_forward_equals_prefill(arch):
    """With capacity >= worst case, train fwd == serving prefill."""
    cfg = configs.get_smoke_config(arch)
    cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    m = get_model(cfg)
    c = P.case(arch)
    b = P.port_batch(c.inputs)
    with torch.no_grad():
        logits, _ = m.forward(c.params, b)
        pre, _ = m.prefill(c.params, b, m.init_cache(2, 64, device="cpu"))
    assert float((pre[:, 0] - logits[:, -1]).abs().max()) < 1e-4


@pytest.mark.parametrize("remat", ["none", "full", "dots_saveable"])
@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b"])
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


def test_consistency_error_grows_with_depth_in_both_packages():
    """A stack of random layers is chaotic: the rounding differences of
    the prefill and decode paths grow with depth in the reference as in
    the port (llama3's smoke config at width 256, 64 tokens): far below
    the check's 1e-3 at 2 layers, past it at 16.  So ``chip_smoke.py``
    holds llama3-8b and zamba2-7b to the check at a cut depth and prints
    the full depth's error."""
    from repro.models import get_model as ref_get_model

    errs = {}
    for n in (2, 16):
        kw = dict(num_layers=n, d_model=256, num_heads=8, num_kv_heads=2,
                  head_dim=32, d_ff=512)
        cfg = configs.get_smoke_config("llama3-8b").replace(**kw)
        m = get_model(cfg)
        p = m.init(torch.Generator().manual_seed(0), device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(1))
        port = P.consistency_error(m, p, {"tokens": toks})
        rm = ref_get_model(ref_configs.get_smoke_config("llama3-8b").replace(
            **kw))
        rp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
        rt = jnp.asarray(toks.numpy().astype(np.int32))
        full, _ = rm.prefill(rp, {"tokens": rt}, rm.init_cache(2, 64))
        _, cache = rm.prefill(rp, {"tokens": rt[:, :-1]},
                              rm.init_cache(2, 64))
        dec, _ = rm.decode_step(rp, rt[:, -1:], cache)
        ref = float(jnp.max(jnp.abs(dec[:, 0] - full[:, 0]))) / (
            float(jnp.max(jnp.abs(full))) + 1e-6)
        errs[n] = (port, ref)
    assert max(errs[2]) < 1e-4, errs
    assert min(errs[16]) > 1e-3, errs
