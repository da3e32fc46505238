"""Port vs reference: the executable registry (``serve/exec_registry.py``).

* **Keys.**  The port's :class:`ExecKey` of a pipeline equals the
  reference's ``exec_key_for`` of the same rung, receiver options and
  schema on every field but ``backend`` (the port's is the pipeline's
  device type), weights included where they are carried across; it is
  also the same string in a fresh process.
* **Templates.**  The port's template slots and batches have the
  reference's slot schema, open loop and HARQ.
* **Bucket policies.**  Each of the reference's seven policy cases gives
  the reference's ``bucket_for`` over ``1..max_n`` and its ``buckets``;
  the Fixed and CostModel edge cases are the reference's.
* **Registry.**  A re-acquire is an in-memory hit; a capacity-bounded
  registry evicts LRU-first and drops the evicted step's buffers.
* **Captured step** (on the CPU: the staging, key checks and accounting
  of the CUDA graph path, with the eager chain in place of the replay;
  ``tests/test_torch_cuda.py`` holds the replay to eager on the card).  A
  step refuses a batch of another schema, shape, dtype or side info, and
  staging batch B after batch A gives ``pipeline.run(B)``'s outputs.

Reference tests with no counterpart here: ``test_disk_cache_round_trip``,
``test_cache_detaches_after_builds`` and ``test_get_registry_follows_env``
test the persistent XLA cache and its ``REPRO_XLA_CACHE`` directory, which
the port does not have (a CUDA graph cannot outlive its process).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.phy import link as ref_link
from repro.phy import scenarios as ref_scn
from repro.serve import exec_registry as ref_er
from repro_torch.phy import coding, link, models, scenarios
from repro_torch.serve import PhyServeEngine, runtime
from repro_torch.serve.exec_registry import (
    CapturedStep, CostModelBuckets, ExecKey, ExecRegistry, ExecStats,
    FixedBuckets, PowerOfTwoBuckets, exec_key_for, get_registry,
    set_registry, slot_schema, template_batch, template_slot,
)
from _port_share import port_share  # noqa: F401

_SCN = "siso-qam16-r12-snr15"


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind,options", [
    ("classical", {"fused": True}),
    ("classical", {"fused": True, "sic": True}),
    ("classical", {"fused": True, "precision": "int8"}),
    ("classical", {}),
    ("deeprx", {}),
])
def test_exec_key_matches_reference(kind, options):
    ref_p = ref_link.build_pipeline(kind, ref_scn.get_scenario(_SCN),
                                    **options)
    kw = dict(options)
    if kind == "deeprx":  # the reference's weights, carried across
        kw["params"] = models.deeprx_params_from_numpy(
            _np_tree(ref_p.params), "cpu")
    port_p = link.build_pipeline(kind, scenarios.get_scenario(_SCN),
                                 device="cpu", **kw)
    schema = "y_time+y+x+h+bits+info_bits+rv+prior_llr"
    want = dataclasses.asdict(ref_er.exec_key_for(ref_p, 4, schema=schema))
    got = dataclasses.asdict(exec_key_for(port_p, 4, schema=schema))
    assert got.pop("backend") == "cpu"
    want.pop("backend")
    assert got == want


_KEY_PROG = (
    "from repro_torch.phy import link; "
    "from repro_torch.phy.scenarios import get_scenario; "
    "from repro_torch.serve.exec_registry import exec_key_for; "
    f"p = link.build_pipeline('classical', get_scenario('{_SCN}'), "
    "fused=True, device='cpu'); "
    "print(exec_key_for(p, 4, lanes=2, donate=True, schema='s'))"
)


def test_exec_key_stable_across_processes():
    import repro_torch

    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", _KEY_PROG],
                         capture_output=True, text=True, env=env,
                         check=True)
    p = link.build_pipeline("classical", scenarios.get_scenario(_SCN),
                            fused=True, device="cpu")
    here = str(exec_key_for(p, 4, lanes=2, donate=True, schema="s"))
    assert out.stdout.strip().splitlines()[-1] == here
    base = exec_key_for(p, 4)
    for other in (exec_key_for(p, 8), exec_key_for(p, 4, lanes=2),
                  exec_key_for(p, 4, donate=True),
                  exec_key_for(p, 4, schema="y+bits")):
        assert other != base
    assert exec_key_for(p, 4) == base
    assert hash(exec_key_for(p, 4)) == hash(base)


def test_template_schema_matches_reference():
    ref = ref_scn.get_scenario(_SCN)
    port = scenarios.get_scenario(_SCN)
    for harq in (False, True):
        assert slot_schema(template_slot(port, harq=harq, device="cpu")) == \
            ref_er.slot_schema(ref_er.template_slot(ref, harq=harq))
    open_s = slot_schema(template_slot(port, device="cpu"))
    harq_s = slot_schema(template_slot(port, harq=True, device="cpu"))
    assert open_s != harq_s  # HARQ slots carry rv + prior_llr
    batch = template_batch(port, 3, harq=True, device="cpu")
    assert slot_schema(batch) == harq_s
    assert batch["bits"].shape[0] == 3
    assert tuple(batch["prior_llr"].shape) == (
        3, coding.codewords_per_slot(port), port.code.n_mother)


# ---------------------------------------------------------------------------
# bucket policies
# ---------------------------------------------------------------------------

_POLICIES = [  # the reference's seven cases: (constructor args, max_n)
    ("PowerOfTwoBuckets", (), {}, 13),
    ("PowerOfTwoBuckets", (), {"base": 3}, 13),
    ("FixedBuckets", ([2, 5, 13],), {}, 13),
    ("CostModelBuckets", (13,), {}, 13),
    ("CostModelBuckets", (13,), {"compile_cost": 0.01}, 13),
    ("CostModelBuckets", (13,), {"compile_cost": 1e9}, 13),
    ("CostModelBuckets", (12,), {"quantum": 3}, 12),
]


@pytest.mark.parametrize("name,args,kw,max_n", _POLICIES)
def test_bucket_policy_matches_reference(name, args, kw, max_n):
    from repro_torch.serve import exec_registry

    port = getattr(exec_registry, name)(*args, **kw)
    ref = getattr(ref_er, name)(*args, **kw)
    assert port.buckets(max_n) == ref.buckets(max_n)
    got = [port.bucket_for(n) for n in range(1, max_n + 1)]
    assert got == [ref.bucket_for(n) for n in range(1, max_n + 1)]
    # the contract: every count maps onto a registered bucket >= it
    registered = set(port.buckets(max_n))
    assert all(b >= n and b in registered for n, b in enumerate(got, 1))
    assert registered == set(got)


def test_bucket_policy_edge_cases():
    assert [PowerOfTwoBuckets(base=2).bucket_for(n)
            for n in (1, 2, 3, 4, 5, 8, 9)] == [2, 2, 4, 4, 8, 8, 16]
    pol = FixedBuckets([4, 2, 8])
    assert pol.sizes == (2, 4, 8)
    assert pol.bucket_for(8) == 8
    for bad in (9, 0):
        with pytest.raises(ValueError):
            pol.bucket_for(bad)
    with pytest.raises(ValueError):
        FixedBuckets([])
    # compile cost ~free -> one bucket per count; enormous -> one bucket
    assert CostModelBuckets(6, compile_cost=1e-9).sizes == (1, 2, 3, 4, 5, 6)
    assert CostModelBuckets(6, compile_cost=1e9).sizes == (6,)
    q = CostModelBuckets(10, quantum=4, compile_cost=0.1)
    assert all(b % 4 == 0 for b in q.sizes) and q.bucket_for(10) >= 10
    skew = CostModelBuckets(8, weights=[0, 0, 100, 0, 0, 0, 0, 1],
                            compile_cost=0.5)
    assert 3 in skew.sizes
    with pytest.raises(ValueError):
        CostModelBuckets(4, weights=[1.0, 2.0])
    with pytest.raises(ValueError):
        CostModelBuckets(0)


# ---------------------------------------------------------------------------
# registry residency and stats
# ---------------------------------------------------------------------------

def _mkkey(i: int, **kw) -> ExecKey:
    return ExecKey(scenario=f"s{i}", receiver="r", precision="fp32",
                   batch=1, lanes=0, backend="cpu", **kw)


def test_in_memory_reacquire_is_a_hit():
    reg = ExecRegistry()
    stats = ExecStats()
    fn = lambda b: {"out": torch.tanh(b["x"]) @ b["x"].T}
    x = torch.arange(12.0).reshape(3, 4)
    step = reg.acquire(_mkkey(0), fn, {"x": x}, stats=stats)
    again = reg.acquire(_mkkey(0), fn, {"x": x}, stats=stats)
    assert again is step
    assert reg.stats.executables_compiled == 1 and reg.stats.cache_hits == 1
    assert stats.executables_compiled == 1 and stats.cache_hits == 1
    assert stats.compile_time_s == reg.stats.compile_time_s > 0.0
    torch.testing.assert_close(step({"x": x})["out"], torch.tanh(x) @ x.T)
    assert step.replays == 1 and reg.report()["lookups"] == 2


def test_capacity_evicts_lru_first():
    reg = ExecRegistry(capacity=2)
    ex = {"x": torch.ones(2, 2)}
    fns = [lambda b, i=i: {"y": b["x"] + i} for i in range(3)]
    steps = [reg.acquire(_mkkey(i), fns[i], ex) for i in range(3)]
    assert len(reg) == 2 and reg.evictions == 1
    assert _mkkey(0) not in reg  # least recently acquired went first
    assert steps[0].static == {}  # the evicted step dropped its buffers
    assert _mkkey(1) in reg and _mkkey(2) in reg
    # touching key 1 protects it; key 2 is now LRU
    reg.acquire(_mkkey(1), fns[1], ex)
    reg.acquire(_mkkey(0), fns[0], ex)
    assert _mkkey(2) not in reg and _mkkey(1) in reg
    rep = reg.report()
    assert rep["resident"] == 2 and rep["evictions"] == 2
    assert reg.stats.executables_compiled == 4 and reg.stats.cache_hits == 1


# ---------------------------------------------------------------------------
# the captured pipeline step on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classical_step():
    scn = scenarios.get_scenario(_SCN)
    p = link.build_pipeline("classical", scn, fused=True, device="cpu")
    reg = ExecRegistry()
    step = reg.acquire_pipeline_step(
        p, template_batch(scn, 2, harq=True, device="cpu"), batch=2)
    return scn, p, reg, step


def _served_batch(scn, seed: int, rv: int) -> dict:
    """Two users' HARQ slots from the port's own generator, stacked as the
    scheduler stacks them (a nonzero prior on the retransmission)."""
    factory = runtime.TorchSlotFactory("cpu")
    slots = []
    for u in range(2):
        slot = factory(seed + u, scn, 1, rv=rv)
        rng = np.random.default_rng(seed + u)
        slot["prior_llr"] = (rng.standard_normal(
            (1, coding.codewords_per_slot(scn), scn.code.n_mother))
            * rv).astype(np.float32)
        slots.append(slot)
    return runtime.stack_slots(slots)


def test_staging_b_after_a_gives_pipeline_run_of_b(classical_step):
    scn, p, reg, step = classical_step
    a, b = _served_batch(scn, 100, 0), _served_batch(scn, 200, 1)
    for batch in (a, b, a):
        got = step(batch)
        want = p.run(batch)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    # the step staged copies: the caller's batch is never aliased
    assert all(step.static[k].data_ptr() != b[k].data_ptr()
               for k in b if isinstance(b[k], torch.Tensor))
    key = exec_key_for(p, 2, schema=slot_schema(a))
    assert reg.acquire_pipeline_step(p, b, batch=2) is step
    assert key in reg and reg.stats.cache_hits >= 1


def test_captured_step_refuses_another_schema_or_shape(classical_step):
    scn, p, _, step = classical_step
    good = _served_batch(scn, 300, 0)
    open_loop = {k: v for k, v in good.items()
                 if k not in ("rv", "prior_llr")}
    with pytest.raises(ValueError, match="keys"):
        step(open_loop)
    wider = runtime.stack_slots(
        [template_slot(scn, harq=True, device="cpu")], 2)  # batch 3
    with pytest.raises(ValueError, match="'y_time'"):
        step(wider)
    with pytest.raises(ValueError, match="'prior_llr'"):
        step(dict(good, prior_llr=good["prior_llr"].double()))
    with pytest.raises(ValueError, match="'extra'"):
        CapturedStep(p.run, dict(good, extra=1))(dict(good, extra=2))
    assert step(good)["crc_ok"].shape == (2, coding.codewords_per_slot(scn))


def test_open_loop_engine_acquires_its_step_before_the_window():
    reg = ExecRegistry()
    reports = []
    set_registry(reg)  # the engines serve through the process-wide one
    try:
        for _ in range(2):
            eng = PhyServeEngine.from_scenario(_SCN, batch_size=2,
                                               device="cpu", fused=True)
            eng.submit_traffic(7, n_users=3)
            reports.append(eng.run())
    finally:
        set_registry(None)
    first, second = reports
    assert (first.executables_compiled, first.cache_hits) == (1, 0)
    assert first.compile_time_s > 0.0
    # the second engine's pipeline has the same key: a registry hit
    assert (second.executables_compiled, second.cache_hits) == (0, 1)
    assert second.compile_time_s == 0.0 and len(reg) == 1
    assert first.n_batches == second.n_batches == 2
    assert get_registry() is not reg  # dropped: a fresh default next time


def test_a_shrunk_copy_of_a_scenario_gets_its_own_step():
    """A scenario's name, which the key holds, does not fix its grid: a
    process-wide registry that served the registered scenario must not
    hand its step to a 64-subcarrier copy of the same name (the step
    would refuse the batch).  Each shape set is an entry of its own; a
    re-acquire of either is a hit."""
    reg = ExecRegistry()
    full = scenarios.get_scenario(_SCN)
    small = full.replace(grid=dataclasses.replace(
        full.grid, n_subcarriers=64, fft_size=64, n_taps=4,
        delay_spread=1.0))
    steps = []
    for scn in (full, small):
        p = link.build_classical(scn, fused=True, device="cpu")
        batch = runtime.stack_slots(
            [template_slot(scn, harq=True, device="cpu")], 1)  # batch 2
        step = reg.acquire_pipeline_step(p, batch, batch=2)
        assert step(batch)["crc_ok"].shape[0] == 2
        assert reg.acquire_pipeline_step(p, batch, batch=2) is step
        steps.append(step)
    assert steps[0] is not steps[1] and len(reg) == 2
    assert reg.keys()[0] == reg.keys()[1]  # one key, two shape sets
    assert reg.stats.cache_hits == 2
