"""repro_torch.launch.dryrun on smoke configs, in a subprocess (the fake
group is process-wide): each cell traced on an 8-rank fake group's (4, 2)
mesh and on a one-rank (1, 1) mesh.  Every report is ``ok`` with finite
terms; the (4, 2) step sends collectives and the (1, 1) step none; the
memory term is ``hbm_traffic``'s total; the (1, 1) FLOPs equal the
unsharded step's (opprofile on plain ``meta`` tensors); the placed
arguments are smaller on (4, 2) than on (1, 1).  A decode cell whose
override names fp32 params keeps them: the same FLOPs, and the memory term reads the weights at 4 bytes (``hbm_traffic``'s
policy reads them at 2)."""
import json
import math
import os
import subprocess
import sys
from _port_share import port_share  # noqa: F401

SCRIPT = r"""
import dataclasses, json, math
import torch
from repro_torch.analysis.costmodel import MeshShape, hbm_traffic
from repro_torch.analysis.opprofile import profile_step
from repro_torch.common.params import schema_shapes
from repro_torch.configs import ShapeConfig, TrainConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

CELLS = [("llama3-8b", ShapeConfig("t", 32, 8, "train")),
         ("llama3-8b", ShapeConfig("d", 64, 8, "decode")),
         ("moonshot-v1-16b-a3b", ShapeConfig("t", 32, 8, "train")),
         ("whisper-tiny", ShapeConfig("p", 32, 8, "prefill"))]
out = []
for arch, shape in CELLS:
    smoke = get_smoke_config(arch)
    # the smoke widths; the params' dtype left to the production policy
    over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name != "param_dtype"}
    for dims in ((1, 4, 2), (1, 1, 1)):
        res, rep = dryrun.lower_cell(arch, shape, False, cfg_override=over,
                                     dims=dims)
        cfg = smoke.replace(param_dtype="bfloat16") if shape.kind == "train" \
            else smoke
        row = {"arch": arch, "kind": shape.kind, "dims": dims,
               "status": res["status"], "counts": res["collective_counts"],
               "hbm": res["hbm_bytes"], "flops": res["flops"],
               "arg": res["arg_bytes"], "ratio": res["model_flops_ratio"],
               "terms": [res["compute_s"], res["memory_s"],
                         res["collective_s"], res["t_overlap_s"]],
               "traffic": hbm_traffic(cfg, shape, MeshShape(*dims))["total"],
               "row": rep.row()}
        if dims == (1, 1, 1) and shape.kind == "train":
            m = get_model(cfg)
            p = schema_shapes(m.schema())
            batch = m.input_specs(shape)
            prof, _ = profile_step(step_lib.make_train_step(m, TrainConfig()),
                                   {"params": p, "opt": adamw.init(p)}, batch)
            row["plain_flops"] = prof.flops
        out.append(row)

# a decode cell that keeps fp32 params (a measured step's): the same
# FLOPs, the weights read at 4 bytes where the policy reads 2
shape = ShapeConfig("d", 64, 8, "decode")
smoke = get_smoke_config("llama3-8b")
over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
res, _ = dryrun.lower_cell("llama3-8b", shape, False, cfg_override=over,
                           dims=(1, 1, 1))
traffic = hbm_traffic(smoke, shape, MeshShape(1, 1, 1))
fp32 = {"hbm": res["hbm_bytes"], "flops": res["flops"],
        "arg": res["arg_bytes"], "dtype": res["param_dtype"],
        "traffic": traffic["total"], "weights": traffic["weights"]}
dryrun.dist.destroy_process_group()
print(json.dumps({"rows": out, "fp32": fp32}))
"""


def test_dry_run_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    rows = got["rows"]
    assert len(rows) == 8
    for r in rows:
        assert r["status"] == "ok", r
        assert all(math.isfinite(t) and t >= 0 for t in r["terms"]), r
        assert r["hbm"] == r["traffic"], r
        assert 0 < r["ratio"] <= 1, r
        if r["dims"] == [1, 4, 2]:
            assert sum(r["counts"].values()) > 0, r
        else:
            assert r["counts"] == {}, r
        if "plain_flops" in r:
            assert r["flops"] == r["plain_flops"], r
    by = {(r["arch"], r["kind"], tuple(r["dims"])): r for r in rows}
    for (arch, kind, dims), r in by.items():
        if dims == (1, 4, 2):
            assert r["arg"] < by[(arch, kind, (1, 1, 1))]["arg"]
    # fp32 params named by the override: kept, and read at their width
    fp32, bf16 = got["fp32"], by[("llama3-8b", "decode", (1, 1, 1))]
    assert fp32["dtype"] == "float32" and fp32["flops"] == bf16["flops"]
    assert fp32["hbm"] == fp32["traffic"] + fp32["weights"]
    assert bf16["hbm"] == fp32["traffic"]
