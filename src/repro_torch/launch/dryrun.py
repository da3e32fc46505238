"""Dry run: trace every (arch x shape x mesh) cell against the production
mesh on a fake process group of 256 or 512 ranks, and build the roofline
from the traced step (port of :mod:`repro.launch.dryrun`).

The reference lowers and compiles each cell against 512 placeholder XLA
host devices and reads FLOPs and collectives off the compiled HLO.  The
port's counterpart of those placeholder devices is a fake process group
(``torch.testing._internal.distributed.fake_pg``): one process holds rank
0 of a 256- or 512-rank group, the production ``DeviceMesh`` is built on
it, and the cell's state, batch and cache are ``meta`` tensors placed as
DTensors by the sharding rules.  One train step, prefill or decode then
runs under :func:`repro_torch.analysis.opprofile.profile_step` and the
activation mesh: DTensor's sharding propagation decides every collective
(the fake group completes them without moving data), and the per-rank
local ops give the FLOPs.  Nothing is allocated and no card is used, so
this is a host tool and takes no ``device=``.  The memory term is
:func:`repro_torch.analysis.costmodel.hbm_traffic`'s total, as in the
reference.

How each report field is obtained:

* ``flops``, ``collective_*``, ``hbm_bytes_unfused``: the traced step
  (:mod:`repro_torch.analysis.opprofile`);
* ``hbm_bytes``: ``hbm_traffic(cfg, shape, mesh)["total"]``, its weights
  read at the params' own width where the caller names their dtype;
* ``arg_bytes``: the exact local bytes of the placed state and batch (and
  cache); ``temp_bytes``: the traced run's ``peak_live_bytes`` (the peak
  of the local bytes the step's ops allocated and still referenced, a
  lower bound; see :mod:`repro_torch.analysis.opprofile`);
  ``out_bytes``: the local bytes of what the step returns;
* ``trace_s``: the traced run's seconds (the reference's ``compile_s``;
  its ``lower_s`` and ``hlo_bytes`` have no counterpart).

Like the reference it must run as its own process: the fake group is
process-wide.  ``torch.testing._internal.distributed.fake_pg`` must exist
in the installed torch; without it the dry run raises (there is no
fallback).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch.analysis.costmodel import MeshShape, hbm_traffic
from repro_torch.analysis.opprofile import profile_step
from repro_torch.analysis.roofline import (
    H100_SXM_BF16, MemStats, active_params, build_report, model_flops_ideal,
)
from repro_torch.common.params import (
    count_params, schema_shapes, tree_leaves, tree_map,
)
from repro_torch.configs import (
    SHAPES, ShapeConfig, TrainConfig, applicable_shapes, get_config,
)
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

POD_AXES = ("pod", "data", "model")


def start_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake group of ``world`` ranks (a
    group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_dims(multi_pod: bool) -> tuple:
    return (2, 16, 16) if multi_pod else (1, 16, 16)


def mesh_name(dims: tuple) -> str:
    return "x".join(map(str, dims if dims[0] > 1 else dims[1:]))


def _local_bytes(tree) -> int:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.to_local() if hasattr(x, "to_local") else x
            total += x.numel() * x.element_size()
    return total


def _meta_cast(tree, dtype):
    """Floating leaves of a ``meta`` tree as ``dtype`` (the serving
    params)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=dtype,
                                          device="meta")
                    if t.is_floating_point() else t, tree)


def _weights_at(traffic: dict, shape, dtype: torch.dtype) -> float:
    """``hbm_traffic``'s total with its weight bytes read at ``dtype``'s
    width: the cost model prices them at its policy's (2 bytes serving, 4
    training)."""
    w_b = 2 if shape.kind != "train" else 4
    width = torch.empty((), dtype=dtype).element_size()
    return traffic["total"] + traffic["weights"] * (width / w_b - 1)


def lower_cell(arch: str, shape: Union[str, ShapeConfig], multi_pod: bool,
               cfg_override=None, mode: str = "base", microbatches: int = 1,
               dims: Optional[tuple] = None):
    """Trace one cell; ``dims`` overrides the production mesh (a
    ``(pod, data, model)`` shape, e.g. ``(1, 1, 1)`` for one card).

    The params follow the production numeric policy (bf16 params and fp32
    Adam moments for train, bf16 serving params) unless ``cfg_override``
    names their ``param_dtype``: then the cell is the program that keeps
    them so (a measured step's), and the memory term reads the weights
    at that width (see :func:`_weights_at`)."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = cfg.replace(**cfg_override)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    own_dtype = "param_dtype" in (cfg_override or {})
    if shape.kind == "train" and not own_dtype:
        # production numeric policy: bf16 params, fp32 Adam moments
        cfg = cfg.replace(param_dtype="bfloat16")
    # the params' dtype: the serving policy casts them to the compute dtype
    p_dt = cfg.pdtype() if own_dtype or shape.kind == "train" else cfg.dtype()
    dims = tuple(dims or mesh_dims(multi_pod))
    chips = math.prod(dims)
    start_fake_group(chips)
    model = get_model(cfg)
    if dims[0] > 1:
        mesh = make_mesh(dims, POD_AXES)
    else:
        mesh = make_mesh(dims[1:], POD_AXES[1:])
    pshard = shd.param_shardings(model, mesh, mode=mode)
    rules = shd.ACT_RULES_FSDP if mode == "fsdp" else shd.ACT_RULES
    batch_specs = model.input_specs(shape)
    batch = shd.distribute(batch_specs,
                           shd.batch_shardings(batch_specs, mesh, rules))
    params = schema_shapes(model.schema())

    t0 = time.perf_counter()
    with shd.activation_mesh(mesh, mode=mode):
        if shape.kind == "train":
            tc = TrainConfig(microbatches=microbatches)
            state_sh = {"params": pshard,
                        "opt": shd.opt_state_shardings(pshard, mesh)}
            state = shd.distribute(
                {"params": params, "opt": adamw.init(params)}, state_sh)
            args = (state, batch)
            fn = step_lib.make_train_step(model, tc)
        else:
            p = shd.distribute(_meta_cast(params, p_dt), pshard)
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     device="meta")
            cache = shd.distribute(cache,
                                   shd.cache_shardings(cfg, cache, mesh))
            if shape.kind == "prefill":
                args = (p, batch, cache)
                fn = model.prefill
            elif shape.kind == "decode":
                args = (p, batch["tokens"], cache)
                fn = model.decode_step
            else:
                raise ValueError(shape.kind)
        arg_bytes = _local_bytes(args)
        t_place = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof, out = profile_step(fn, *args)
        t_trace = time.perf_counter() - t0
    out_bytes = _local_bytes(out)

    n_params = count_params(model.schema())
    n_active = active_params(cfg, n_params)
    mf = model_flops_ideal(cfg, shape, n_active)
    traffic = hbm_traffic(cfg, shape, MeshShape(*dims))
    hbm = (_weights_at(traffic, shape, p_dt) if own_dtype
           else traffic["total"])
    rep = build_report(
        cell=f"{arch}:{shape.name}",
        mesh_name=mesh_name(dims),
        chips=chips,
        prof=prof,
        model_flops_global=mf,
        mem_stats=MemStats(arg_bytes, int(prof.peak_live_bytes), out_bytes),
        hbm_bytes_model=hbm,
    )
    result = rep.to_json()
    result.update(
        param_dtype=str(p_dt).replace("torch.", ""),
        n_params=n_params,
        n_params_active=n_active,
        machine=H100_SXM_BF16.name,
        place_s=round(t_place, 2),
        trace_s=round(t_trace, 2),
        status="ok",
    )
    return result, rep


def run_cell(arch, shape_name, multi_pod, out_dir=None, verbose=True,
             mode="base", microbatches=1, tag_suffix="", **kw):
    name = mesh_name(tuple(kw.get("dims") or mesh_dims(multi_pod)))
    sname = shape_name if isinstance(shape_name, str) else shape_name.name
    tag = f"{arch}__{sname}__{name}{tag_suffix}"
    try:
        result, rep = lower_cell(arch, shape_name, multi_pod, mode=mode,
                                 microbatches=microbatches, **kw)
        if verbose:
            print(rep.row())
            print(
                f"    args={result['arg_bytes']/1e9:.2f}GB "
                f"temp={result['temp_bytes']/1e9:.2f}GB "
                f"fits={result['fits_hbm']} "
                f"trace={result['trace_s']}s "
                f"colls={result['collective_counts']}"
            )
    except Exception as e:
        result = {
            "cell": f"{arch}:{sname}",
            "mesh": name,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
        if verbose:
            print(f"{tag}: ERROR {type(e).__name__}: {e}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", default="base",
                    choices=["base", "sp", "fsdp", "serve_tp"],
                    help="sharding mode (perf variants)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="", help="suffix for the output JSON")
    args = ap.parse_args(argv)

    try:
        if args.all:
            for arch in ARCH_IDS:
                cfg = get_config(arch)
                for shape_name in applicable_shapes(cfg):
                    meshes = ([False, True] if args.both_meshes
                              else [args.multipod])
                    for mp in meshes:
                        run_cell(arch, shape_name, mp, out_dir=args.out)
            return
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        meshes = [False, True] if args.both_meshes else [args.multipod]
        for mp in meshes:
            run_cell(args.arch, args.shape, mp, out_dir=args.out,
                     mode=args.mode, microbatches=args.microbatches,
                     tag_suffix=args.tag)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
