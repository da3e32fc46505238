"""tests/test_distributed.py on the port: the sharded train step on a host
mesh of 8 gloo CPU processes ((4, 2) over data x model, one thread each;
the reference's 8 forced XLA host devices), against the port's own
unsharded steps and the live reference.

One JAX subprocess (8 host devices) writes the reference's llama3 smoke
parameters (``PRNGKey(0)``), its unsharded step-0 loss on
``TokenStream(vocab, 8, 32, seed=0)``, and the moonshot smoke forward
through its ``shard_map`` dispatch on a (4, 2) mesh.  Then 8 torch
processes, each from the carried parameters:

* 8 steps of ``Trainer`` on the mesh (state placed by ``param_shardings``
  / ``opt_state_shardings``), each beside the unsharded ``Trainer``'s step
  from the same state: losses finite and falling (the reference test's
  criterion), equal at rtol 1e-5, step 0 equal to the reference's
  unsharded loss at rtol 1e-5.  (Two 8-step trajectories drift apart
  faster: the shards sum the gradients in another order, and Adam
  carries the rounding on into the next steps' losses, 1.3e-5 relative
  by step 6.)
* the sharded prefill (params and cache placed, under the activation
  mesh) finite and equal to the unsharded prefill (atol 1e-5 of the
  largest logit: the model-axis partial sums add in another order), and
  so are one decode step after it and the cache it leaves; a device
  offset's write into one seq-sharded cache buffer equals the plain
  write, for one row, rows across the shard boundary, more rows than a
  shard holds and a clamped start; a forward of 3 sequences, which
  neither mesh axis divides, equal to the unsharded one (atol 1e-5 of
  the largest logit);
* the moonshot forward through ``local_map`` (per-shard capacity) equal
  to the reference's ``shard_map`` forward at the LM parity tolerance
  (rtol 1e-4, atol 1e-5 of the largest logit); on 2 x 15 tokens, which
  the 4 data shards do not divide, equal to the port's forward
  without a mesh (atol 1e-5 of the largest logit: the experts still
  split over ``model``, the partial sums add in another order); on 3 x 16
  tokens (the rows do not split over the data shards, the tokens do)
  equal to the reference's sharded forward at the parity tolerance.

The reference and the ranks run one thread each.
"""
import json
import os
import subprocess
import sys

import numpy as np
from _port_share import port_share  # noqa: F401

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import TrainConfig, get_smoke_config
from repro.data import TokenStream
from repro.distributed import sharding as shd
from repro.models import get_model
from repro.optim import adamw
from repro.train import step as step_lib

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out

out = {}
cfg = get_smoke_config("llama3-8b")
m = get_model(cfg)
params = m.init(jax.random.PRNGKey(0))
stream = TokenStream(cfg.vocab_size, 8, 32, seed=0)
batch = {k: jnp.asarray(v) for k, v in stream.batch_at(0).items()}
state = {"params": params, "opt": adamw.init(params)}
_, met = jax.jit(step_lib.make_train_step(
    m, TrainConfig(learning_rate=1e-3, microbatches=1)))(state, batch)
out["loss0"] = np.asarray(met["loss"])
out.update({"llama/" + k: v for k, v in flat(params).items()})

cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(compute_dtype="float32")
m = get_model(cfg)
params = m.init(jax.random.PRNGKey(0))
tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
_AxisType = getattr(jax.sharding, "AxisType", None)
kw = {} if _AxisType is None else {"axis_types": (_AxisType.Auto,) * 2}
mesh = jax.make_mesh((4, 2), ("data", "model"), **kw)
with shd.activation_mesh(mesh):
    logits, _ = jax.jit(lambda p, b: m.forward(p, b))(params, {"tokens": jnp.asarray(tokens)})
    # 3 sequences: 4 data shards do not divide the rows, but they divide
    # the 48 tokens, so the dispatch still takes per-shard capacity
    logits3, _ = jax.jit(lambda p, b: m.forward(p, b))(
        params, {"tokens": jnp.asarray(tokens[:3])})
out["moe_tokens"] = tokens
out["moe_logits"] = np.asarray(logits)
out["moe3_logits"] = np.asarray(logits3)
out.update({"moe/" + k: v for k, v in flat(params).items()})
np.savez(sys.argv[1], **out)
"""

PORT_SCRIPT = r"""
import json, os, sys, time
import numpy as np
import torch, torch.distributed as dist
import torch.multiprocessing as mp


def nested(npz, prefix):
    out = {}
    for k in npz.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = npz[k]
    return out


def run(rank, world, port, ref_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    from repro_torch.common.params import params_from_numpy
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer

    ref = np.load(ref_path)
    mesh = make_host_mesh(model_axis=2)
    res = {}
    cfg = get_smoke_config("llama3-8b")
    m = get_model(cfg)
    tc = TrainConfig(learning_rate=1e-3, microbatches=1)
    stream = TokenStream(cfg.vocab_size, 8, 32, seed=0)
    params = params_from_numpy(m.schema(), nested(ref, "llama/"), "cpu")
    carried = lambda: {"params": {k: v for k, v in params.items()},
                       "opt": adamw.init(params)}
    quiet = lambda *a, **k: None
    plain_tr = Trainer(m, tc, stream, device="cpu")
    pshard = shd.param_shardings(m, mesh)
    ssh = {"params": pshard, "opt": shd.opt_state_shardings(pshard, mesh)}
    tr = Trainer(m, tc, stream, mesh=mesh, state_shardings=ssh, device="cpu")
    state = shd.distribute(carried(), ssh)
    res["sharded"], res["plain"] = [], []
    t0 = time.perf_counter()
    for i in range(8):
        # the unsharded step from the sharded trajectory's state (rank 0
        # reports; the others only gather)
        full = shd.full_tensor(state)
        if rank == 0:
            _, _, hist = plain_tr.run(full, i, 1, log_fn=quiet)
            res["plain"].append(float(hist[0]["loss"]))
        del full
        state, _, hist = tr.run(state, i, 1, log_fn=quiet)
        res["sharded"].append(float(hist[0]["loss"]))
    res["sharded_s"] = time.perf_counter() - t0

    with torch.no_grad():
        full = shd.full_tensor(state["params"])
        tokens = torch.ones((8, 16), dtype=torch.int32)
        plain_cache = m.init_cache(8, 64, device="cpu")
        want, _ = m.prefill(full, {"tokens": tokens}, plain_cache)
        want_dec, _ = m.decode_step(full, tokens[:, :1], plain_cache)
        with shd.activation_mesh(mesh):
            cache = m.init_cache(8, 64, device="cpu")
            cache = shd.distribute(cache, shd.cache_shardings(cfg, cache, mesh))
            got, cache = m.prefill(state["params"], {"tokens": tokens}, cache)
            got = got.full_tensor()
            got_dec, cache = m.decode_step(state["params"], tokens[:, :1],
                                           cache)
            got_dec = got_dec.full_tensor()
            kv = cache["k"].full_tensor()
        res["prefill_finite"] = bool(torch.isfinite(got).all())
        res["prefill_err"] = float((got - want).abs().max()
                                   / want.abs().max())
        res["decode_err"] = float((got_dec - want_dec).abs().max()
                                  / want_dec.abs().max())
        res["decode_cache_err"] = float((kv - plain_cache["k"]).abs().max()
                                        / plain_cache["k"].abs().max())
        # 3 sequences, which neither mesh axis divides: the attention
        # gathers its heads, the rows stay whole
        three = {"tokens": tokens[:3]}
        want3, _ = m.forward(full, three)
        with shd.activation_mesh(mesh):
            got3, _ = m.forward(state["params"], three)
            got3 = got3.full_tensor()
        res["three_rows_err"] = float((got3 - want3).abs().max()
                                      / want3.abs().max())

        # write_cache at a device offset into one layer's seq-sharded
        # buffer (2 shards of 32): one row, rows across the shard
        # boundary, rows past each shard's length, a clamped start
        from repro_torch.models.layers import write_cache
        sh = shd.cache_shardings(cfg, cache, mesh)["k"]
        res["writes_equal"] = []
        for s, p in ((1, 40), (3, 30), (40, 10), (5, 62)):
            g = torch.Generator().manual_seed(s)
            buf = torch.randn(cache["k"].shape, generator=g)
            new = torch.randn((8, s) + buf.shape[3:], generator=g)
            placed = shd.distribute(buf.clone(), sh)
            write_cache(buf[0], new, torch.tensor(p))
            write_cache(placed[0], new, torch.tensor(p))
            res["writes_equal"].append(bool(torch.equal(
                placed.full_tensor(), buf)))

        cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(
            compute_dtype="float32")
        m = get_model(cfg)
        placed = params_from_numpy(m.schema(), nested(ref, "moe/"), "cpu",
                                   shardings=shd.param_shardings(m, mesh))
        tokens = torch.from_numpy(ref["moe_tokens"])
        with shd.activation_mesh(mesh):
            logits, _ = m.forward(placed, {"tokens": tokens})
            logits = logits.full_tensor()
        want = torch.from_numpy(ref["moe_logits"])
        res["moe_err"] = float(((logits - want).abs()
                                - 1e-4 * want.abs()).max()
                               / want.abs().max())
        # 2 x 15: 30 tokens that 4 data shards do not divide, so the rows
        # stay whole (the local path's slots), the experts still split
        # over model; against the port's forward without a mesh
        res["moe_ep"] = cfg.num_experts % mesh.size(1) == 0
        few = {"tokens": tokens[:2, :15]}
        with shd.activation_mesh(mesh):
            logits, _ = m.forward(placed, few)
            logits = logits.full_tensor()
        want, _ = m.forward(shd.full_tensor(placed), few)
        res["moe_whole_rows_err"] = float((logits - want).abs().max()
                                          / want.abs().max())
        # 3 x 16: the rows do not split over the 4 data shards, the 48
        # tokens do (per-shard capacity, as the reference's shard_map);
        # against the reference's sharded forward
        with shd.activation_mesh(mesh):
            logits, _ = m.forward(placed, {"tokens": tokens[:3]})
            logits = logits.full_tensor()
        want = torch.from_numpy(ref["moe3_logits"])
        res["moe3_err"] = float(((logits - want).abs()
                                 - 1e-4 * want.abs()).max()
                                / want.abs().max())
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(8, port, sys.argv[1], sys.argv[2]), nprocs=8)
"""


def _env():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    # one thread a process: the 8 ranks and the reference share the
    # machine with the other test workers
    return dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def test_sharded_train_step_8dev(tmp_path):
    ref_path, out_path = tmp_path / "ref.npz", tmp_path / "port.json"
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(ref_path)],
                         capture_output=True, text=True, env=_env(),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    script = tmp_path / "port.py"
    script.write_text(PORT_SCRIPT)
    out = subprocess.run([sys.executable, str(script), str(ref_path),
                          str(out_path)], capture_output=True, text=True,
                         env=_env(), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out_path.read_text())
    ref = np.load(ref_path)

    sharded, plain = np.array(res["sharded"]), np.array(res["plain"])
    assert np.isfinite(sharded).all()
    assert sharded[-1] < sharded[0], sharded
    np.testing.assert_allclose(sharded, plain, rtol=1e-5)
    np.testing.assert_allclose(sharded[0], float(ref["loss0"]), rtol=1e-5)
    assert res["prefill_finite"]
    assert res["prefill_err"] < 1e-5, res["prefill_err"]
    assert res["decode_err"] < 1e-5 and res["decode_cache_err"] < 1e-5, res
    assert res["writes_equal"] == [True] * 4, res["writes_equal"]
    assert res["moe_err"] < 1e-5, res
    assert res["moe_ep"] and res["moe_whole_rows_err"] < 1e-5, res
    assert res["three_rows_err"] < 1e-5, res
    assert res["moe3_err"] < 1e-5, res
