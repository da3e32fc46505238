"""Port vs reference: the checkpoint manager (``checkpoint/manager.py``)
and the single-cell supervised engine (``PhyServeEngine(supervised=
True)``, ``serve/supervisor.py::SupervisedBatchRunner``).

* **The reference's five checkpoint tests** on nested dicts of tensors:
  round trip, keep-k and latest, async save, no partial checkpoint
  visible, restore into a shape-only target.
* **Names and files interoperate.**  The port's leaf names equal the
  reference's ``_flatten_with_names`` on the same tree (dict keys sorted,
  sequence entries by index, ``None`` an empty subtree); a checkpoint
  written by either package restores in the other.
* **Placement.**  ``restore`` gives each leaf the target leaf's dtype and
  device (a numpy or shape-only leaf goes to the requested device) and
  raises on a shape mismatch.
* **Supervised single-cell serving** on the CPU: a batch with ``inf`` in
  one slot's ``y_time`` degrades once to the fp32 unfused reference
  pipeline and comes out finite; a clean batch is served exactly as the
  unsupervised engine serves it; an injected step error is retried, and
  exhausted retries raise.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_names
from repro_torch.phy import coding, link, ofdm, scenarios
from repro_torch.serve import (
    BatchRunner, InjectedFault, PhyServeEngine, SupervisedBatchRunner,
)
from repro_torch.serve.exec_registry import ExecRegistry
from _port_share import port_share  # noqa: F401


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g),
                   "b": torch.zeros(16)},
        "opt": {"mu": {"w": torch.ones(8, 16), "b": torch.zeros(16)},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree) -> list:
    return list(_flatten_with_names(tree).values())


# -- the reference's tests, on tensors --------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = _state()
    mgr.save(100, state)
    restored = mgr.restore(100, state)
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [20, 30]
    assert mgr.latest_step() == 30


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, _state())
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_no_partial_checkpoint_visible(tmp_path):
    """A committed dir always has both files (atomic rename contract)."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _state())
    d = os.path.join(tmp_path, "step_00000001")
    assert sorted(os.listdir(d)) == ["arrays.npz", "manifest.json"]


def test_restore_into_shape_only_target(tmp_path):
    """Restore needs only the target's structure, shapes and dtypes (the
    reference's ShapeDtypeStruct leaves; here ``meta`` tensors)."""
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    state = _state()
    mgr.save(1, state)
    target = {"params": {k: torch.empty_like(v, device="meta")
                         for k, v in state["params"].items()},
              "opt": {"mu": {k: torch.empty_like(v, device="meta")
                             for k, v in state["opt"]["mu"].items()},
                      "step": torch.empty((), dtype=torch.int32,
                                          device="meta")}}
    restored = mgr.restore(1, target, device="cpu")
    assert restored["params"]["w"].shape == (8, 16)
    assert int(restored["opt"]["step"]) == 7
    assert torch.equal(restored["params"]["w"], state["params"]["w"])


# -- names and files interoperate -------------------------------------------

def _mixed_tree() -> dict:
    """Nested dicts (keys out of order), a list, a tuple and a
    ``None``, with arrays of several dtypes."""
    rng = np.random.default_rng(3)
    return {
        "zeta": [rng.standard_normal((3, 2)).astype(np.float32),
                 (np.arange(5, dtype=np.int64), None,
                  np.asarray([True, False]))],
        "alpha": {"b": rng.standard_normal(4).astype(np.float32),
                  "a": (rng.standard_normal((2, 2)) + 1j).astype(
                      np.complex64),
                  "c": np.asarray(3, np.int32)},
        "mid": np.arange(6, dtype=np.uint8).reshape(2, 3),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.array(tree))


def test_leaf_names_equal_the_reference():
    tree = _mixed_tree()
    want = ref_manager._flatten_with_names(tree)
    for got in (_flatten_with_names(tree),
                _flatten_with_names(_to_torch(tree))):
        assert list(got) == list(want)
    assert list(want) == ["alpha/a", "alpha/b", "alpha/c", "mid", "zeta/0",
                          "zeta/1/0", "zeta/1/2"]


def test_checkpoints_restore_across_packages(tmp_path):
    tree = _mixed_tree()
    # the reference writes, the port restores (on the targets' devices)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_manager.CheckpointManager(str(ref_dir), async_save=False).save(
        4, jax.tree.map(jnp.asarray, tree))
    port = CheckpointManager(str(ref_dir), async_save=False)
    assert port.latest_step() == 4
    got = port.restore(4, _to_torch(tree))
    for name, leaf in _flatten_with_names(got).items():
        want = _flatten_with_names(tree)[name]
        assert leaf.device.type == "cpu" and leaf.numpy().dtype == want.dtype
        np.testing.assert_array_equal(leaf.numpy(), want)
    # the port writes (from tensors), the reference restores
    CheckpointManager(str(port_dir), async_save=False).save(
        9, _to_torch(tree))
    ref = ref_manager.CheckpointManager(str(port_dir), async_save=False)
    back = ref.restore(9, tree)
    for name, want in _flatten_with_names(tree).items():
        np.testing.assert_array_equal(
            np.asarray(ref_manager._flatten_with_names(back)[name]), want)
    assert sorted(ref.load_flat(9)) == sorted(_flatten_with_names(tree))


def test_restore_follows_target_dtype_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state()
    mgr.save(2, state)
    target = {
        "params": {"w": torch.zeros(8, 16, dtype=torch.float64),
                   "b": np.zeros(16, np.float16)},  # numpy: the device
        "opt": {"mu": {"w": torch.zeros(8, 16, dtype=torch.bfloat16),
                       "b": torch.zeros(16)},
                "step": np.zeros((), np.int64)},
    }
    got = mgr.restore(2, target, device="cpu")
    assert got["params"]["w"].dtype == torch.float64
    assert got["params"]["b"].dtype == torch.float16
    assert got["opt"]["mu"]["w"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int64
    assert all(t.device.type == "cpu" for t in _leaves(got))
    torch.testing.assert_close(got["params"]["w"],
                               state["params"]["w"].double())
    bad = dict(target, params={"w": torch.zeros(16, 8), "b": target[
        "params"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(2, bad, device="cpu")
    # a numpy leaf follows the default device, which is CUDA
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mgr.restore(2, target)


# -- PhyServeEngine(supervised=True) ----------------------------------------

_SMOKE = dict(n_subcarriers=64, fft_size=64, n_taps=4, delay_spread=1.0)


def _small_pipeline(**options):
    scn = scenarios.get_scenario("siso-qam16-r12-snr15")
    scn = scn.replace(grid=dataclasses.replace(scn.grid, **_SMOKE))
    return link.build_pipeline("classical", scn, device="cpu", **options)


def _slots(scn, n: int, seed: int) -> list:
    return [coding.make_coded_slot(ofdm.make_generator(seed + i, "cpu"),
                                   scn, 1) for i in range(n)]


def _engine(pipeline, supervised: bool) -> PhyServeEngine:
    return PhyServeEngine(pipeline, batch_size=2, supervised=supervised)


def test_supervised_engine_degrades_a_corrupted_batch():
    rx = _small_pipeline(fused=True)
    slots = _slots(rx.scenario, 4, seed=50)
    slots[1] = dict(slots[1], y_time=slots[1]["y_time"].clone())
    slots[1]["y_time"][0, 0] = float("inf")
    eng = _engine(rx, supervised=True)
    reqs = [eng.submit(s) for s in slots]
    runner = eng._make_runner()
    assert isinstance(runner, SupervisedBatchRunner)
    runner.registry = ExecRegistry()
    assert runner.drain(reqs) == 2
    # the corrupted batch (slots 0-1) reran once on the unfused reference
    assert runner.degraded_batches == 1 and runner.retries == 0
    assert runner._ref.name == f"classical/{rx.scenario.name}"
    assert all(np.isfinite(r.metrics["ber"]) for r in reqs)
    # without supervision the corruption reaches the combined LLRs
    plain = BatchRunner(rx, 2, registry=ExecRegistry())
    state = plain.run_batch([eng.submit(s) for s in slots[:2]])
    assert not torch.isfinite(state["cw_llr"]).all()


def test_supervised_engine_serves_clean_batches_identically():
    rx = _small_pipeline(fused=True)
    slots = _slots(rx.scenario, 3, seed=70)
    reps = {}
    for supervised in (False, True):
        eng = _engine(rx, supervised)
        reqs = [eng.submit(s) for s in slots]
        rep = eng.run()
        reps[supervised] = (rep, [r.metrics for r in reqs])
    (a, ma), (b, mb) = reps[False], reps[True]
    assert ma == mb
    for f in ("n_slots", "n_batches", "ber", "bler", "decode_iters",
              "che_mse"):
        assert getattr(a, f) == getattr(b, f), f
    runner = _engine(rx, True)._make_runner()
    runner.drain([_engine(rx, False).submit(s) for s in slots])
    assert runner.degraded_batches == 0 and runner.retries == 0


def test_from_scenario_keeps_the_positional_order():
    """``device`` stays the fourth positional argument; ``supervised`` is
    keyword-only, as the retry settings stay ``__init__``'s."""
    scn = _small_pipeline().scenario
    eng = PhyServeEngine.from_scenario(scn, "classical", 2, "cpu")
    assert eng.pipeline.device.type == "cpu" and not eng.supervised
    assert type(eng._make_runner()) is BatchRunner
    eng = PhyServeEngine.from_scenario(scn, "classical", 2, "cpu",
                                       supervised=True, fused=True)
    assert eng.supervised and eng.receiver == "classical"
    assert isinstance(eng._make_runner(), SupervisedBatchRunner)
    with pytest.raises(TypeError):
        PhyServeEngine.from_scenario(scn, "classical", 2, "cpu", True)


def test_supervised_runner_retries_then_raises():
    rx = _small_pipeline()
    slots = _slots(rx.scenario, 2, seed=90)

    def flaky(fails: int):
        runner = SupervisedBatchRunner(rx, 2, max_retries=2,
                                       registry=ExecRegistry())
        real = runner._step
        left = [fails]

        def step(batch):
            if left[0]:
                left[0] -= 1
                raise InjectedFault("injected")
            return real(batch)

        runner._step = step
        return runner

    eng = _engine(rx, False)
    runner = flaky(2)  # two failures fit the budget of two retries
    runner.drain([eng.submit(s) for s in slots])
    assert runner.retries == 2 and runner.n_batches == 1
    runner = flaky(3)
    with pytest.raises(InjectedFault):
        runner.drain([eng.submit(s) for s in slots])
    assert runner.retries == 2
