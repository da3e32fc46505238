"""The port's LM sharding rules (repro_torch.distributed.sharding) against
the live reference (repro.distributed.sharding): every case of
tests/test_sharding.py replayed on the port, then a sweep of every rule
set over the (16, 16), (2, 16, 16) and (4, 2) meshes and the schema and
cache leaves of all ten configs (spec for spec), and the DTensor
placements of each spec giving every rank the reference's local shard (a
fake 8-rank group for the (4, 2) mesh)."""
import functools
import itertools
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import get_model as ref_get_model
from repro_torch.common.params import schema_shapes, tree_leaves
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed import sharding as shd
from repro_torch.models import get_model
from _port_share import port_share  # noqa: F401


class FakeMesh:
    """Shape-only stand-in so spec tests don't need 256 devices."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


MESH = FakeMesh((16, 16), ("data", "model"))
MESH_MP = FakeMesh((2, 16, 16), ("pod", "data", "model"))
MESH_HOST = FakeMesh((4, 2), ("data", "model"))
MESHES = {"16x16": MESH, "2x16x16": MESH_MP, "4x2": MESH_HOST}


# -- tests/test_sharding.py on the port ---------------------------------------

def test_param_rules_basic():
    spec = shd.spec_for((4096, 14336), ("embed", "mlp"), shd.PARAM_RULES, MESH)
    assert spec == ("data", "model")


def test_divisibility_fallback_kv_heads():
    spec = shd.spec_for((4096, 8, 128), ("embed", "kv_heads", "head_dim"),
                        shd.PARAM_RULES, MESH)
    assert spec == ("data", None, None)


def test_axis_reuse_guard():
    spec = shd.spec_for((16, 6144, 10752), ("expert", "embed", "mlp"),
                        shd.PARAM_RULES, MESH)
    assert spec == ("model", "data", None)


def test_batch_sharding_multipod():
    spec = shd.spec_for((256, 4096), ("batch", "seq"), shd.ACT_RULES, MESH_MP)
    assert spec == (("pod", "data"), None)
    spec2 = shd.spec_for(
        (13, 1, 524288, 32, 112),
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        shd.ACT_RULES, MESH_MP)
    assert spec2 == (None, None, ("data", "model"), None, None)
    spec3 = shd.spec_for(
        (32, 128, 32768, 8, 128),
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        shd.ACT_RULES, MESH_MP)
    assert spec3 == (None, ("pod", "data"), "model", None, None)


def test_cache_axes_cover_all_families():
    for arch in ("llama3-8b", "zamba2-7b", "rwkv6-1.6b", "whisper-tiny"):
        cfg = get_smoke_config(arch)
        cache = get_model(cfg).init_cache(2, 32, device="meta")
        axes = shd.cache_axes(cfg, cache)
        for k, v in cache.items():
            assert len(axes[k]) == len(v.shape), f"{arch}:{k}"


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 8))
    assert shd.constrain(x, ("batch", "embed")) is x


def test_serve_tp_rules_no_data_axis_on_params():
    spec = shd.spec_for((4096, 14336), ("embed", "mlp"),
                        shd.PARAM_RULES_SERVE, MESH)
    assert spec == (None, "model")
    spec2 = shd.spec_for((16, 6144, 10752), ("expert", "embed", "mlp"),
                         shd.PARAM_RULES_SERVE, MESH)
    assert spec2 == ("model", None, None)


def test_fsdp_rules_2d_weight_sharding():
    spec = shd.spec_for((4096, 14336), ("embed", "mlp"),
                        shd.PARAM_RULES_FSDP, MESH)
    assert spec == (("data", "model"), None)
    bspec = shd.spec_for((256, 4096), ("batch", "seq"),
                         shd.ACT_RULES_FSDP, MESH)
    assert bspec == (("data", "model"), None)


def test_sp_rules_seq_over_model():
    spec = shd.spec_for((16, 4096, 4096), ("batch", "seq", "embed"),
                        shd.ACT_RULES_SP, MESH)
    assert spec == ("data", "model", None)


# -- the rule tables and the sweep ----------------------------------------------

TABLES = ("PARAM_RULES", "PARAM_RULES_SERVE", "PARAM_RULES_FSDP",
          "ACT_RULES", "ACT_RULES_SP", "ACT_RULES_FSDP", "ACT_RULES_PHY")


@pytest.mark.parametrize("name", TABLES)
def test_rule_tables_equal_reference(name):
    assert getattr(shd, name) == getattr(ref_shd, name)


def _ref_spec(shape, axes, rules, mesh) -> tuple:
    return tuple(ref_shd.spec_for(tuple(shape), tuple(axes), rules, mesh))


def _cache_shapes(arch: str) -> list:
    """(batch, max_len) of the arch's serving cells."""
    cfg = get_config(arch)
    return sorted({(SHAPES[s].global_batch, SHAPES[s].seq_len)
                   for s in applicable_shapes(cfg)
                   if SHAPES[s].kind != "train"})


@functools.lru_cache(maxsize=None)
def leaves(arch: str) -> tuple:
    """(params, caches) of the arch's published config: each a list of
    (name, shape, logical axes), the port's checked equal to the
    reference's (schema leaves in flatten order; the cache of every
    serving cell)."""
    from repro.common.params import Param as RefParam

    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    m, rm = get_model(cfg), ref_get_model(ref_cfg)
    params = [(str(i), tuple(p.shape), tuple(p.axes))
              for i, p in enumerate(tree_leaves(m.schema()))]
    ref_params = [(str(i), tuple(p.shape), tuple(p.axes))
                  for i, p in enumerate(jax.tree.leaves(
                      rm.schema(), is_leaf=lambda x: isinstance(x, RefParam)))]
    assert params == ref_params, arch
    caches = []
    for b, s in _cache_shapes(arch):
        cache = m.init_cache(b, s, device="meta")
        ref_cache = jax.eval_shape(lambda: rm.init_cache(b, s))
        axes = shd.cache_axes(cfg, cache)
        assert axes == ref_shd.cache_axes(ref_cfg, ref_cache), arch
        for k, v in cache.items():
            assert tuple(v.shape) == tuple(ref_cache[k].shape), (arch, k)
            caches.append((k, tuple(v.shape), axes[k]))
        tok = (b, 1)
        caches.append(("tokens", tok, ("batch", None)))
    return params, caches


PARAM_TABLES = ("PARAM_RULES", "PARAM_RULES_SERVE", "PARAM_RULES_FSDP")
ACT_TABLES = ("ACT_RULES", "ACT_RULES_SP", "ACT_RULES_FSDP")


@pytest.mark.parametrize("table", PARAM_TABLES + ACT_TABLES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_equals_reference_on_every_leaf(table, mesh):
    """The port's spec_for equals the reference's, entry for entry, for
    every schema leaf (param tables) or cache and token leaf (activation
    tables) of all ten configs."""
    which = 0 if table in PARAM_TABLES else 1
    rules, ref_rules = getattr(shd, table), getattr(ref_shd, table)
    n = 0
    for arch in ARCH_IDS:
        for name, shape, axes in leaves(arch)[which]:
            got = shd.spec_for(shape, axes, rules, MESHES[mesh])
            want = _ref_spec(shape, axes, ref_rules, MESHES[mesh])
            assert got == want, (arch, name, shape, axes, got, want)
            n += 1
    assert n > 100


def _jax_shard(shape, spec, mesh, coord) -> tuple:
    """The reference's (PartitionSpec's) local shard of device ``coord``:
    (shape, offset), several axes of one entry major to minor."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    at = dict(zip(mesh.axis_names, coord))
    local, off = [], []
    for dim, entry in zip(shape, spec):
        group = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = math.prod(sizes[a] for a in group)
        block = 0
        for a in group:
            block = block * sizes[a] + at[a]
        local.append(dim // n)
        off.append(block * (dim // n))
    return tuple(local), tuple(off)


def _coords(mesh) -> list:
    shape = mesh.devices.shape
    every = list(itertools.product(*(range(n) for n in shape)))
    if len(every) <= 8:
        return every
    rng = np.random.default_rng(0)
    pick = rng.choice(len(every), size=6, replace=False)
    return [every[0], every[-1]] + [every[i] for i in pick]


@pytest.mark.parametrize("table", PARAM_TABLES + ACT_TABLES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_give_the_reference_local_shard(table, mesh):
    """Each spec's DTensor placements give every rank of the (4, 2) mesh
    (and sampled ranks of the production meshes) the shard the
    reference's PartitionSpec gives that device: shape and offset."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_of

    which = 0 if table in PARAM_TABLES else 1
    fm = MESHES[mesh]
    rules = getattr(shd, table)
    for arch in ARCH_IDS:
        for name, shape, axes in leaves(arch)[which]:
            spec = shd.spec_for(shape, axes, rules, fm)
            pl = shd.placements(spec, fm)
            for coord in _coords(fm):
                got = local_of(shape, fm.devices.shape, list(coord), pl)
                want = _jax_shard(shape, spec, fm, coord)
                assert (tuple(got[0]), tuple(got[1])) == want, (
                    arch, name, spec, coord)


def test_mesh_builders_need_a_group():
    from repro_torch.launch import mesh as lm

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        lm.make_host_mesh()


@pytest.fixture(scope="module")
def fake8():
    """A fake 8-rank process group (this process is rank 0) and the (4, 2)
    host mesh on it; the group is torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_host_mesh(model_axis=2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b", "zamba2-7b"])
def test_distribute_places_rank0_shard_on_fake_group(fake8, arch):
    """param_shardings / cache_shardings on the fake group's (4, 2) mesh:
    every placed leaf's local tensor on rank 0 has the reference's
    shard shape (smoke configs, ``meta`` tensors)."""
    from torch.distributed.tensor import DTensor

    cfg = get_smoke_config(arch)
    m = get_model(cfg)
    shapes = schema_shapes(m.schema())
    placed = shd.distribute(shapes, shd.param_shardings(m, fake8))
    axes = [p.axes for p in tree_leaves(m.schema())]
    for x, full, ax in zip(tree_leaves(placed), tree_leaves(shapes), axes):
        assert isinstance(x, DTensor)
        spec = _ref_spec(full.shape, ax, ref_shd.PARAM_RULES, MESH_HOST)
        want, _ = _jax_shard(full.shape, spec, MESH_HOST, (0, 0))
        assert tuple(x.to_local().shape) == want
    cache = m.init_cache(8, 64, device="meta")
    placed = shd.distribute(cache, shd.cache_shardings(cfg, cache, fake8))
    ax = shd.cache_axes(cfg, cache)
    for k, v in cache.items():
        spec = _ref_spec(v.shape, ax[k], ref_shd.ACT_RULES, MESH_HOST)
        want, _ = _jax_shard(v.shape, spec, MESH_HOST, (0, 0))
        assert tuple(placed[k].to_local().shape) == want, k


def test_mesh_builders_span_the_group(fake8):
    """make_mesh / make_host_mesh over the group; a shape of another size
    raises (the production meshes need 256 / 512 ranks)."""
    from repro_torch.launch import mesh as lm

    assert fake8.mesh_dim_names == ("data", "model")
    assert tuple(fake8.shape) == (4, 2)
    assert tuple(lm.make_host_mesh().shape) == (8, 1)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        lm.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        lm.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="does not divide"):
        lm.make_host_mesh(model_axis=3)


def test_activation_mesh_is_thread_local_and_nested():
    import threading

    assert shd.get_activation_mesh() is None and shd.sharding_mode() == "base"
    mesh = object()
    seen = []
    with shd.activation_mesh(None, "sp"):
        assert shd.sp_active()
        t = threading.Thread(target=lambda: seen.append(
            (shd.get_activation_mesh(), shd.sharding_mode())))
        t.start()
        t.join()
    assert seen == [(None, "base")]
    assert not shd.sp_active()
    shd.set_activation_mesh(mesh, "fsdp")
    try:
        assert shd.get_activation_mesh() is mesh
    finally:
        shd.set_activation_mesh(None)


def test_opt_and_batch_shardings_follow_the_reference():
    cfg = get_smoke_config("llama3-8b")
    m = get_model(cfg)
    ps = shd.param_shardings(m, MESH_HOST)
    opt = shd.opt_state_shardings(ps, MESH_HOST)
    assert opt["mu"] is ps and opt["nu"] is ps and opt["step"].spec == ()
    assert shd.replicated(MESH_HOST).spec == ()
    specs = m.input_specs(SHAPES["train_4k"])
    b = shd.batch_shardings(specs, MESH_HOST)
    assert {k: v.spec for k, v in b.items()} == {
        k: _ref_spec(v.shape, ("batch",) + (None,) * (v.ndim - 1),
                     ref_shd.ACT_RULES, MESH_HOST) for k, v in specs.items()}
