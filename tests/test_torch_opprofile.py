"""repro_torch.analysis.opprofile against the reference's HLO count
(repro.analysis.hloparse): the unsharded FLOPs of one smoke config a
family (train step, prefill, decode) on one CPU device, and the
collective pricing of DTensor redistributions on a fake group.

Tolerance: 2% relative, and prefill and decode FLOPs are equal exactly.
The train step of the dense, vlm, moe, ssm and audio families is above
the reference's by exactly one unembed product of the batch,
2 x B x S x d_model x vocab FLOPs, which the port executes and XLA's
compiled step does not: the port's chunked loss runs each chunk in a
non-reentrant checkpoint, whose forward is recomputed in the backward (the
unembed GEMM of the forward, of the recompute, and the two of its
gradient), where XLA's step holds one product fewer.  That is 2.0-5.8% of
these tiny configs' steps (vocab 256 against d_model 64), so those four
families are outside 2% by that product alone, and the test holds their
difference to it exactly.  zamba2 (remat "none", the SSD scan's
einsums) is 0.75% above, inside the tolerance.  The families are split
over this file (dense, vlm, moe, and the collective pricing) and
test_torch_opprofile_recurrent.py (hybrid, ssm, audio)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_parity as P
from repro.analysis.hloparse import profile_hlo
from repro.configs import TrainConfig as RefTrainConfig
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.analysis import opprofile
from repro_torch.configs import TrainConfig
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from _port_share import port_share  # noqa: F401

FAMILIES = ["llama3-8b", "pixtral-12b", "moonshot-v1-16b-a3b"]
RTOL = 0.02
# families whose train-step FLOPs exceed the reference's by exactly one
# unembed product (see the module docstring); the others are within RTOL
ONE_MORE_UNEMBED = {"llama3-8b", "pixtral-12b", "moonshot-v1-16b-a3b",
                    "rwkv6-1.6b", "whisper-tiny"}


def _hlo_flops(fn, *args) -> float:
    return profile_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("arch", FAMILIES)
def test_unsharded_flops_equal_the_reference_hlo(arch):
    check_flops(arch)


def check_flops(arch: str) -> None:
    cfg, _, m, rm, params, rp = P.pair(arch)
    rng = np.random.default_rng(0)
    inputs = P.draw_inputs(cfg, rng)
    inputs["labels"] = rng.integers(0, cfg.vocab_size,
                                    inputs["tokens"].shape).astype(np.int32)
    rb = {k: jnp.asarray(v) for k, v in inputs.items()}
    pb = P.port_batch(inputs)

    ref = _hlo_flops(ref_step.make_train_step(rm, RefTrainConfig()),
                     {"params": rp, "opt": ref_adamw.init(rp)}, rb)
    got, _ = opprofile.profile_step(
        step_lib.make_train_step(m, TrainConfig()),
        {"params": params, "opt": adamw.init(params)}, pb)
    b, s = inputs["tokens"].shape
    unembed = 2.0 * b * s * cfg.d_model * cfg.vocab_size
    if arch in ONE_MORE_UNEMBED:
        assert got.flops - ref == unembed, (got.flops, ref, unembed)
    else:
        assert abs(got.flops - ref) <= RTOL * ref, (got.flops, ref)
    assert got.conv_flops == 0

    rbp = {k: v for k, v in rb.items() if k != "labels"}
    pbp = {k: v for k, v in pb.items() if k != "labels"}
    ref = _hlo_flops(lambda p, x, c: rm.prefill(p, x, c), rp, rbp,
                     rm.init_cache(P.B, P.MAX_LEN))
    with torch.no_grad():
        got, _ = opprofile.profile_step(
            m.prefill, params, pbp, m.init_cache(P.B, P.MAX_LEN, device="cpu"))
    assert got.flops == ref

    tok = np.zeros((P.B, 1), np.int32)
    ref = _hlo_flops(lambda p, t, c: rm.decode_step(p, t, c), rp,
                     jnp.asarray(tok), rm.init_cache(P.B, P.MAX_LEN))
    with torch.no_grad():
        got, _ = opprofile.profile_step(
            m.decode_step, params, torch.from_numpy(tok),
            m.init_cache(P.B, P.MAX_LEN, device="cpu"))
    assert got.flops == ref
    assert got.boundary_bytes > 0 and got.collective_counts == {}


_PRICING = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.analysis.opprofile import profile_step
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh((4, 2), ("data", "model"))
x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                      (Shard(0), Replicate()))
part = DTensor.from_local(torch.empty(16, 32, device="meta"), mesh,
                          (Shard(0), Partial()), run_check=False)
out = {}
for name, fn in [
        ("gather", lambda: x.redistribute(mesh, (Replicate(), Replicate()))),
        ("all_to_all", lambda: x.redistribute(mesh, (Shard(1), Replicate()))),
        ("reduce", lambda: part.redistribute(mesh, (Shard(0), Replicate()))),
        ("scatter", lambda: part.redistribute(mesh, (Shard(0), Shard(1))))]:
    p, _ = profile_step(fn)
    out[name] = [p.collective_counts, p.collective_operand_bytes,
                 p.collective_wire_bytes, p.collective_wire_bytes_f32]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collectives_priced_by_the_reference_formulas():
    """On a fake (4, 2) group, a 64 x 32 fp32 tensor sharded 4 ways on
    dim 0 (a 2 KiB local shard): the gather over ``data`` is an all-gather
    of the local shard, (g-1) x 2 KiB on the wire; the Shard(0) ->
    Shard(1) move is an all-to-all (DTensor's CPU fallback, an all-gather,
    is priced as the all-to-all it stands for), (g-1)/g x 2 KiB; a partial
    sum over ``model`` reduced to replicated is an all-reduce, 2(g-1)/g x
    the operand; reduced to a shard, a reduce-scatter, (g-1)/g x the
    operand."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    res = subprocess.run([sys.executable, "-c", _PRICING], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    shard = 16 * 32 * 4
    assert out["gather"] == [{"all-gather": 1}, shard, 3 * shard, 3 * shard]
    assert out["all_to_all"] == [{"all-to-all": 1}, shard, 0.75 * shard,
                                 0.75 * shard]
    assert out["reduce"] == [{"all-reduce": 1}, shard, shard, shard]
    assert out["scatter"] == [{"reduce-scatter": 1}, shard, 0.5 * shard,
                              0.5 * shard]
