"""The port's roofline (repro_torch.analysis.costmodel's LM traffic model,
repro_torch.analysis.roofline) against the live reference: MeshShape,
hbm_traffic over every arch x applicable shape x both production meshes,
the calibration point, the ideal model FLOPs, the active parameters, the
step energy and build_report on equal profile fields, each to 1e-12
relative; then tests/test_roofline.py's report and cost-model cases on
the port (its HLO loop-weighting cases have no counterpart: there is no
HLO)."""
import dataclasses

import pytest

from repro.analysis import costmodel as ref_cm
from repro.analysis import roofline as ref_rl
from repro.analysis.hloparse import HloProfile
from repro.common.params import count_params as ref_count
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.core.machine import Machine as RefMachine
from repro.models import get_model as ref_get_model
from repro_torch.analysis import costmodel as cm
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.opprofile import OpProfile
from repro_torch.common.params import count_params
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.machine import H100_SXM, H100_SXM_TENSOR_FLOPS
from repro_torch.models import get_model
from _port_share import port_share  # noqa: F401

REL = 1e-12


def close(got, want, what=""):
    assert got == pytest.approx(want, rel=REL, abs=0.0), (what, got, want)


def cells():
    for arch in ARCH_IDS:
        for shape in applicable_shapes(get_config(arch)):
            yield arch, shape


def test_mesh_shape_equals_reference():
    for mp in (False, True):
        a, b = cm.MeshShape.from_multipod(mp), ref_cm.MeshShape.from_multipod(mp)
        assert (a.pod, a.data, a.model, a.dp, a.chips) == (
            b.pod, b.data, b.model, b.dp, b.chips)
    m = cm.MeshShape(1, 4, 2)
    assert (m.dp, m.chips) == (4, 8)


@pytest.mark.parametrize("arch,shape", list(cells()))
def test_hbm_traffic_equals_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for mp in (False, True):
        got = cm.hbm_traffic(cfg, SHAPES[shape], cm.MeshShape.from_multipod(mp))
        want = ref_cm.hbm_traffic(ref_cfg, REF_SHAPES[shape],
                                  ref_cm.MeshShape.from_multipod(mp))
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], (arch, shape, mp, k))
        if SHAPES[shape].kind != "train":
            close(cm._kv_cache_bytes(cfg, SHAPES[shape],
                                     cm.MeshShape.from_multipod(mp)),
                  ref_cm._kv_cache_bytes(ref_cfg, REF_SHAPES[shape],
                                         ref_cm.MeshShape.from_multipod(mp)))


def test_calibration_point_equals_reference():
    got, want = cm.calibration_point(), ref_cm.calibration_point()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, str):
            assert a == b
        else:
            close(a, b, f.name)
    for prop in ("te_j", "pe_j", "l1_j", "dma_j", "static_j", "total_j",
                 "ops", "gops_per_watt", "l1_residency", "avg_power_w"):
        close(getattr(got, prop), getattr(want, prop), prop)
    assert 4.0 < got.avg_power_w < 4.6


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    n = count_params(get_model(cfg).schema())
    assert n == ref_count(ref_get_model(ref_cfg).schema())
    na = rl.active_params(cfg, n)
    close(na, ref_rl.active_params(ref_cfg, n))
    for shape in applicable_shapes(cfg):
        close(rl.model_flops_ideal(cfg, SHAPES[shape], na),
              ref_rl.model_flops_ideal(ref_cfg, REF_SHAPES[shape], na))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8", "fp8"])
def test_step_energy_equals_reference(precision):
    for flops, hbm, t in ((1e12, 1e9, 1e-3), (3.3e9, 7e11, 0.2)):
        close(rl.step_energy_j(flops, hbm, t, precision),
              ref_rl.step_energy_j(flops, hbm, t, precision))


def _machines():
    """The port's and the reference's Machine with the same numbers."""
    port = rl.H100_SXM_BF16
    ref = RefMachine(name=port.name, peak_flops=port.peak_flops,
                     hbm_bw=port.hbm_bw, link_bw=port.link_bw,
                     fast_mem_bytes=port.fast_mem_bytes,
                     freq_hz=port.freq_hz)
    return port, ref


@dataclasses.dataclass
class _Mem:
    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int


@pytest.mark.parametrize("fields", [
    dict(dot_flops=1e12, boundary_bytes=1e9, collective_wire_bytes=1e7),
    dict(dot_flops=1e9, conv_flops=2e8, boundary_bytes=1e12,
         collective_wire_bytes=1e7, collective_operand_bytes=3e6),
    dict(dot_flops=5e11, boundary_bytes=2e9, collective_wire_bytes=9e10,
         collective_operand_bytes=4e10,
         collective_counts={"all-gather": 12, "reduce-scatter": 3}),
])
def test_build_report_equals_reference_on_equal_fields(fields):
    """With no fp32 share in the wire bytes (the one field the two
    packages price differently, see the next test), every report field is
    the reference's."""
    port_m, ref_m = _machines()
    kw = dict(cell="a:b", mesh_name="16x16", chips=256,
              model_flops_global=2.56e14, xla_flops_raw=0.0,
              hbm_capacity=80e9, hbm_bytes_model=3.1e10, precision="bf16")
    mem = _Mem(10**9, 2 * 10**9, 10**8)
    got = rl.build_report(prof=OpProfile(**fields), machine=port_m,
                          mem_stats=rl.MemStats(10**9, 2 * 10**9, 10**8),
                          **kw).to_json()
    want = ref_rl.build_report(prof=HloProfile(**fields), machine=ref_m,
                               mem_stats=mem, **kw).to_json()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            close(got[k], v, k)
        else:
            assert got[k] == v, k


def test_fp32_wire_share_is_not_halved():
    """The reference halves the fp32 share of its wire bytes (XLA:CPU
    carries bf16 collectives in fp32); DTensor's payloads are already in
    the program's dtypes, so the port prices them whole."""
    prof = OpProfile(dot_flops=1e9, collective_wire_bytes=8e9,
                     collective_wire_bytes_f32=6e9)
    ref = HloProfile(dot_flops=1e9, collective_wire_bytes=8e9,
                     collective_wire_bytes_f32=6e9)
    assert prof.collective_wire_bytes_bf16corr == 8e9
    assert ref.collective_wire_bytes_bf16corr == 5e9
    rep = rl.build_report("a:b", "16x16", 256, prof, 1e12)
    close(rep.collective_s, 8e9 / H100_SXM.link_bw)


def test_default_machine_is_the_h100_bf16_peak():
    m = rl.H100_SXM_BF16
    assert m.peak_flops == H100_SXM_TENSOR_FLOPS["bf16"] == 989e12
    assert (m.hbm_bw, m.link_bw) == (H100_SXM.hbm_bw, H100_SXM.link_bw)
    rep = rl.build_report("a:b", "1x1", 1, OpProfile(dot_flops=1e9), 1e9,
                          mem_stats=rl.MemStats(79 * 10**9, 0, 10**9))
    assert rep.fits_hbm is False  # 80e9 bytes of HBM


# -- tests/test_roofline.py on the port -----------------------------------------

def test_build_report_bottleneck_classification():
    prof = OpProfile(dot_flops=1e12, boundary_bytes=1e9,
                     collective_wire_bytes=1e7)
    rep = rl.build_report("x:y", "16x16", 256, prof, model_flops_global=2.56e14)
    assert rep.bottleneck == "compute"
    assert rep.compute_s > rep.memory_s
    assert 0 < rep.mfu_overlap <= 1.0 + 1e-6
    prof2 = OpProfile(dot_flops=1e9, boundary_bytes=1e12,
                      collective_wire_bytes=1e7)
    rep2 = rl.build_report("x:y", "16x16", 256, prof2,
                           model_flops_global=2.56e11)
    assert rep2.bottleneck == "memory"


def test_costmodel_scales_sanely():
    cfg = get_config("llama3-8b")
    mesh = cm.MeshShape(1, 16, 16)
    tr_train = cm.hbm_traffic(cfg, SHAPES["train_4k"], mesh)
    tr_dec = cm.hbm_traffic(cfg, SHAPES["decode_32k"], mesh)
    assert 0.9e9 < tr_dec["weights"] < 2.2e9
    assert tr_train["total"] > 10 * tr_dec["total"]
    assert (tr_dec["weights"] + tr_dec["kv"]) / tr_dec["total"] > 0.5


def test_model_flops_ideal():
    cfg = get_config("llama3-8b")
    mf = rl.model_flops_ideal(cfg, SHAPES["train_4k"], 8e9)
    assert mf == pytest.approx(6 * 8e9 * 256 * 4096)
    mf_dec = rl.model_flops_ideal(cfg, SHAPES["decode_32k"], 8e9)
    assert mf_dec == pytest.approx(2 * 8e9 * 128)


def test_report_row_and_json():
    rep = rl.build_report("llama3-8b:train_4k", "16x16", 256,
                          OpProfile(dot_flops=2e12, boundary_bytes=5e9,
                                    collective_counts={"all-gather": 4}),
                          1e14)
    row = rep.row()
    assert row.startswith("llama3-8b:train_4k") and "->" in row
    js = rep.to_json()
    assert js["collective_counts"] == {"all-gather": 4}
    assert js["precision"] == "bf16"


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "decode"),
                                       ("smollm-360m", "train")])
def test_an_undercounted_profile_fails_the_flops_gate(arch, kind):
    """``chip_smoke.py`` phase 10 gates each dry run on the unclamped
    ratio of its ideal FLOPs to the executed FLOPs of all ranks
    (``build_report``'s ``model_flops_ratio`` stops at 1, so it cannot
    show an under-count).  The traced step of a smoke config on ``meta``
    tensors passes; the same profile with half its products missing
    fails.  llama3-8b's untied input embedding is a gather, taken out of
    the ideal; smollm-360m's is tied to the unembed."""
    import torch

    from repro_torch.analysis.opprofile import profile_step
    from repro_torch.common.params import schema_shapes
    from repro_torch.configs import ShapeConfig, TrainConfig, get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    cfg = get_smoke_config(arch)
    m = get_model(cfg)
    params = schema_shapes(m.schema())
    shape = ShapeConfig("s", 32, 4, kind)
    if kind == "train":
        prof, _ = profile_step(step_lib.make_train_step(m, TrainConfig()),
                               {"params": params, "opt": adamw.init(params)},
                               m.input_specs(shape))
    else:
        with torch.no_grad():
            prof, _ = profile_step(
                m.decode_step, params,
                torch.zeros((4, 1), dtype=torch.int32, device="meta"),
                m.init_cache(4, 32, device="meta"))
    n_active = rl.active_params(cfg, count_params(m.schema()))
    ideal = rl.model_flops_ideal(cfg, shape, n_active)
    smoke = _chip_smoke()

    def ratio(p):
        row = rl.build_report("c", "1x1", 1, p, ideal).to_json()
        assert row["model_flops_ratio"] <= 1.0  # clamped either way
        return smoke.executed_flops_ratio(
            dict(row, n_params_active=n_active), cfg)

    assert 0 < ratio(prof) <= 1.0
    assert ratio(dataclasses.replace(prof, dot_flops=prof.dot_flops / 2)) > 1
