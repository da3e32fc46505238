"""Port vs reference: the launch-choice autotuner (``repro_torch.kernels.
tune`` against ``repro.kernels.tune``) and the kernels' pickers.

The cache's keys, file format and persistence are the reference's: the
same ``cache_key`` strings for the same arguments, a file written by
either package read by the other, lazy loads that read a missing or
corrupt file as empty, atomic saves.  The candidates are the Hopper
kernels' own launch choices, so each ``pick_*`` is held to three rules:
the heuristic with an empty cache (equal, at the main paths' shapes, to
what the kernels' host code picked before it took the choice as an
argument), a valid cached winner on ``cuda`` when there is one, and the
heuristic again for a stale or impossible entry.  On the CPU the tuners
time the plain twins and persist their winners under ``cpu``; the card
runs them in ``chip_smoke.py`` phase 7 and ``tests/test_torch_cuda.py``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as ref_quant
from repro.kernels import tune as ref_tune
from repro_torch.kernels import ldpc, mha, quant, rx_fused, te_gemm, tune
from repro_torch.phy import coding, ofdm
from _port_share import port_share  # noqa: F401


@pytest.fixture
def cache_path(tmp_path):
    """A fresh process-wide cache file, the environment restored after."""
    path = str(tmp_path / "tune.json")
    tune.set_cache_path(path)
    try:
        yield path
    finally:
        tune.set_cache_path(None)


def _store(op, shape, choice, extra="", backend="cuda", objective="latency"):
    tune.get_cache().store(tune.cache_key(op, shape, extra, backend=backend,
                                          objective=objective), choice, 1.0)


# -- the cache --------------------------------------------------------------

def test_tune_cache_roundtrip(tmp_path):
    path = str(tmp_path / "tune.json")
    cache = tune.TuneCache(path)
    key = tune.cache_key("te_gemm", (256, 256, 384), "float32",
                         backend="cpu")
    assert cache.lookup(key) is None
    cache.store(key, (16, 2), us=42.0, n_candidates=9)
    # a fresh instance reads the persisted winner back
    assert tune.TuneCache(path).lookup(key) == (16, 2)


def test_tune_cache_tolerates_corrupt_file(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    assert tune.TuneCache(str(path)).lookup("anything") is None
    path.write_text(json.dumps({"version": 2, "entries": {"k": {
        "choice": [1]}}}))
    assert tune.TuneCache(str(path)).lookup("k") is None  # other version


def test_tune_cache_tolerates_corruption_and_saves_atomically(tmp_path):
    path = tmp_path / "tune_cache.json"
    path.write_text('{"version": 1, "entries": {truncated garbage')
    cache = tune.TuneCache(str(path))
    assert cache.lookup("anything") is None
    cache.store("op|shape|dtype|cuda", (64, 128), us=12.5, n_candidates=4)
    # the save replaced the corrupt file atomically: valid json, no
    # leftover tmp files in the directory
    data = json.loads(path.read_text())
    assert data["version"] == 1
    assert data["entries"]["op|shape|dtype|cuda"] == {
        "choice": [64, 128], "us": 12.5, "n_candidates": 4}
    assert os.listdir(tmp_path) == [path.name]
    assert tune.TuneCache(str(path)).lookup("op|shape|dtype|cuda") == \
        (64, 128)
    cache.clear()
    assert cache.lookup("op|shape|dtype|cuda") is None


def test_set_cache_path_none_restores_the_environment(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(tune, "_ORIG_ENV", str(tmp_path / "operator.json"))
    tune.set_cache_path(str(tmp_path / "a.json"))
    assert os.environ["REPRO_TUNE_CACHE"] == str(tmp_path / "a.json")
    assert tune.get_cache().path == str(tmp_path / "a.json")
    tune.set_cache_path(None)  # the operator's variable survives
    assert os.environ["REPRO_TUNE_CACHE"] == str(tmp_path / "operator.json")
    monkeypatch.setattr(tune, "_ORIG_ENV", None)
    tune.set_cache_path(None)  # none at import: none again
    assert "REPRO_TUNE_CACHE" not in os.environ
    assert tune.default_cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro-tensorpool", "tune.json")


@pytest.mark.parametrize("args", [
    ("te_gemm", (28672, 32, 288), "float32", "cuda", "latency"),
    ("te_gemm", (256, 256, 256), "int8", "cpu", "energy"),
    ("mha", (32, 64, 64, 16), "", "cuda", "latency"),
    ("rx_detect_demap", (14, 256, 1, 1, 4), "", "cpu", "latency"),
    ("ldpc_decode", (12, 12, 32, 12), "", "gpu", "energy"),
])
def test_cache_key_equals_reference(args):
    op, shape, extra, backend, objective = args
    assert tune.cache_key(op, shape, extra, backend=backend,
                          objective=objective) == ref_tune.cache_key(
        op, shape, extra, backend=backend, objective=objective)


def test_cache_key_distinguishes_one_byte_dtypes():
    shape = (256, 256, 256)
    k_int8 = tune.cache_key("te_gemm", shape, quant.dtype_name(torch.int8))
    k_fp8 = tune.cache_key("te_gemm", shape,
                           quant.dtype_name(quant.FP8_DTYPE))
    assert k_int8 != k_fp8
    assert quant.dtype_name(torch.int8) == ref_quant.dtype_name(jnp.int8)
    assert quant.dtype_name(quant.FP8_DTYPE) == "float8_e4m3fn"


def test_cache_file_crosses_packages_both_ways(tmp_path):
    """One file holds both packages' entries: the reference's (its
    ``cpu`` / ``tpu`` keys) and the port's (``cuda``), each readable by
    the other's ``TuneCache`` after either saved."""
    path = str(tmp_path / "tune.json")
    ref_key = ref_tune.cache_key("te_gemm", (512, 512, 512), "bfloat16",
                                 backend="tpu")
    port_key = tune.cache_key("te_gemm", (512, 512, 512), "bfloat16",
                              backend="cuda")
    ref_tune.TuneCache(path).store(ref_key, (256, 256, 128), 3.0, 9)
    port = tune.TuneCache(path)
    assert port.lookup(ref_key) == (256, 256, 128)
    port.store(port_key, (32, 2), 4.0, 12)
    ref = ref_tune.TuneCache(path)
    assert ref.lookup(port_key) == (32, 2)
    assert ref.lookup(ref_key) == (256, 256, 128)
    ref.store(ref_key, (128, 128, 128), 5.0, 9)
    assert tune.TuneCache(path).lookup(port_key) == (32, 2)
    assert tune.TuneCache(path).lookup(ref_key) == (128, 128, 128)


def test_divisor_candidates_equal_reference():
    for n, cands in ((512, (512, 256, 128)), (96, (64, 32, 16)),
                     (7, (4, 2)), (216, (128, 64, 32, 16, 8, 4))):
        assert tune._divisor_cands(n, cands) == \
            ref_tune._divisor_cands(n, cands)


# -- the pickers --------------------------------------------------------------

# each kernel's launch choice at the main paths' shapes when its host
# code still picked it, worked out from that code: te_gemm.cu's
# dispatch (slab as wide as N, halved while under 64 tiles or while W's
# K did not fit 160 KB) and launch (228 KB // (its shared memory + 2 KB)
# blocks an SM, 1 to 4), te_gemm_quant.cu's dispatch (32 or 64 columns,
# the whole row for a softmax), mha.cu's launch (cluster doubled while
# each block keeps a key tile and the grid stays within 132 SMs),
# ls_che.cu's launch (two threads an output up to 128 outputs a block),
# ldpc_minsum.cu's launch (the widest layer to a power of two, at least
# 4, while z rows of it fit 1024 threads), detect_demap.cu's SCT = 16
_PINNED_GEMM = [
    ((28672, 32, 288, torch.float32, "none"), (32, 2)),  # DeepRx conv
    ((28672, 32, 54, torch.float32, "relu"), (32, 4)),  # DeepRx conv_in
    ((28672, 2, 32, torch.float32, "none"), (8, 4)),  # DeepRx conv_out
    ((28672, 32, 288, torch.bfloat16, "none"), (32, 4)),
    ((512, 192, 64, torch.float32, "none"), (16, 4)),  # CE-ViT wqkv
    ((512, 64, 16, torch.float32, "none"), (8, 4)),  # CE-ViT embed
    ((512, 8, 64, torch.float32, "none"), (8, 4)),  # CE-ViT head
    ((512, 64, 64, torch.float32, "softmax"), (64, 3)),  # whole row
    ((512, 512, 512, torch.float32, "none"), (32, 1)),  # Fig. 10's FC
    ((1024, 128, 16, torch.float32, "none"), (32, 4)),  # training embed
    ((1024, 384, 128, torch.float32, "none"), (64, 2)),  # training wqkv
    ((1024, 128, 128, torch.float32, "none"), (32, 3)),  # training wo
    ((1024, 256, 128, torch.float32, "none"), (64, 2)),  # training w1
    ((1024, 128, 256, torch.float32, "none"), (32, 2)),  # training w2
    ((1024, 8, 128, torch.float32, "none"), (8, 4)),  # training head
    ((28672, 32, 288, torch.int8, "none"), (32,)),
    ((28672, 32, 288, quant.FP8_DTYPE, "none"), (32,)),
    ((256, 256, 256, torch.int8, "none"), (64,)),
    ((64, 200, 64, torch.int8, "softmax"), (256,)),
    ((64, 100, 64, quant.FP8_DTYPE, "softmax"), (128,)),
]


@pytest.mark.parametrize("args,want", _PINNED_GEMM,
                         ids=[str(a[:3]) + str(a[3])[6:] + a[4]
                              for a, _ in _PINNED_GEMM])
def test_gemm_heuristic_pins_pre_tuner_choice(cache_path, args, want):
    m, n, k, dtype, epilogue = args
    assert te_gemm.pick_block_shape(m, n, k, dtype, epilogue) == want


def test_other_heuristics_pin_pre_tuner_choices(cache_path):
    # mha: CE-ViT serving and training, a Fig. 10 block, a long causal
    for args, want in (((32, 64, 64, 16, False), (1,)),
                       ((128, 32, 32, 32, False), (1,)),
                       ((4, 128, 128, 128, True), (2,)),
                       ((16, 256, 256, 64, True), (2,)),
                       ((4, 128, 128, 512, False), (2,)),
                       ((1, 64, 1024, 64, False), (8,))):
        assert mha.pick_cluster(*args, torch.float32, 132) == want, args
    # ls_che: SISO, 2x2 and the MU grid at B = 8, SISO 8 lanes x 8 slots
    for rows, n_rx, n_tx, want in ((8, 1, 1, 2), (16, 2, 2, 1),
                                   (32, 4, 4, 1), (64, 1, 1, 1)):
        n_p = 256 // (2 * n_tx)
        assert rx_fused.pick_threads_per_output(256, n_rx, n_tx, n_p,
                                                rows) == (want,)
    # the decoders: the registered codes, other lifting sizes, wide layers
    for (rate, z, kw), want in ((("r12", 32, {}), 8), (("r34", 32, {}), 8),
                                (("r12", 16, {}), 8), (("r12", 128, {}), 8),
                                (("r12", 384, {}), 0),
                                (("r34", 32, {"k_b": 16, "col_degree": 8}),
                                 0)):
        assert ldpc.pick_segment(coding.make_code(rate, z=z, **kw)) == \
            (want,), (rate, z, kw)
    # detect + demap, joint and SIC, every route: 16 subcarriers a block
    for sic, shape in ((False, (1, 1, 2)), (False, (8, 4, 3)),
                       (True, (4, 4, 2)), (True, (8, 6, 2)),
                       (False, (1, 1, 5))):
        n_rx, n_tx, nb = shape
        assert rx_fused.pick_subcarrier_tile(sic, 14, 256, n_rx, n_tx,
                                             nb) == (16,)


# (op, the picker's call, its cache key's (shape, extra), a valid winner
# other than the heuristic, an entry the kernel has no instance for)
_CODE = coding.make_code("r12")
_PICKERS = {
    "te_gemm": (lambda: te_gemm.pick_block_shape(28672, 32, 288),
                "te_gemm", ((28672, 32, 288), "float32"), (16, 1),
                (48, 2)),
    "te_gemm_bf16": (lambda: te_gemm.pick_block_shape(
        28672, 32, 288, torch.bfloat16), "te_gemm",
        ((28672, 32, 288), "bfloat16"), (8, 2), (32, 5)),
    "te_gemm_quant": (lambda: te_gemm.pick_block_shape(
        64, 200, 64, torch.int8, "softmax"), "te_gemm",
        ((64, 200, 64), "int8"), (256,), (128,)),  # a row wider than 128
    "mha": (lambda: mha.pick_cluster(16, 256, 256, 64, True), "mha",
            ((16, 256, 256, 64), ""), (4,), (8,)),  # 4 key tiles
    "detect": (lambda: rx_fused.pick_subcarrier_tile(
        False, 14, 256, 1, 1, 2), "rx_detect_demap",
        ((14, 256, 1, 1, 4), ""), (8,), (64,)),
    "detect_untiled_route": (lambda: rx_fused.pick_subcarrier_tile(
        False, 14, 256, 4, 4, 2), "rx_detect_demap",
        ((14, 256, 4, 4, 4), ""), (16,), (32,)),  # 16 only there
    "sic": (lambda: rx_fused.pick_subcarrier_tile(
        True, 14, 256, 8, 6, 2), "rx_sic_demap",
        ((14, 256, 8, 6, 4), ""), (32,), (12,)),
    "ldpc": (lambda: ldpc.pick_segment(_CODE), "ldpc_decode",
             ((12, 12, 32, 12), ""), (16,), (4,)),  # layers of 5 edges
    "ls_che": (lambda: rx_fused.pick_threads_per_output(256, 2, 2, 64, 16),
               "rx_ls_che", ((256, 2, 2, 64), ""), (2,), (3,)),
    "ls_che_rows": (lambda: rx_fused.pick_threads_per_output(
        256, 4, 4, 32, 32), "rx_ls_che", ((256, 4, 4, 32), ""), (1,),
        (2,)),  # two threads an output cover 16 rows, not 32
}


@pytest.mark.parametrize("name", sorted(_PICKERS))
def test_picker_heuristic_winner_and_stale_entry(cache_path, name):
    pick, op, (shape, extra), winner, stale = _PICKERS[name]
    heuristic = pick()
    # a winner for another backend or another shape is not this one's
    _store(op, shape, winner, extra, backend="cpu")
    _store(op, tuple(d + 1 for d in shape), winner, extra)
    assert pick() == heuristic
    _store(op, shape, winner, extra)
    assert pick() == winner
    _store(op, shape, stale, extra)  # no instance: the heuristic
    assert pick() == heuristic
    tune.get_cache().clear()
    assert pick() == heuristic


def test_gemm_picker_reads_the_energy_winner_second(cache_path):
    shape = (28672, 32, 288)
    heuristic = te_gemm.pick_block_shape(*shape)
    _store("te_gemm", shape, (8, 1), "float32", objective="energy")
    assert te_gemm.pick_block_shape(*shape) == (8, 1) != heuristic
    _store("te_gemm", shape, (16, 4), "float32")  # latency first
    assert te_gemm.pick_block_shape(*shape) == (16, 4)


def test_pickers_keep_one_byte_tunings_apart(cache_path):
    shape = (512, 512, 512)
    _store("te_gemm", shape, (128,), "int8")
    _store("te_gemm", shape, (256,), "float8_e4m3fn")
    assert te_gemm.pick_block_shape(*shape, torch.int8) == (128,)
    assert te_gemm.pick_block_shape(*shape, quant.FP8_DTYPE) == (256,)


def test_picks_are_memoized_until_the_cache_changes(cache_path, tmp_path,
                                                    monkeypatch):
    shape = (28672, 32, 288)
    heuristic = te_gemm.pick_block_shape(*shape)
    calls = []
    resolve = tune.resolve
    monkeypatch.setattr(tune, "resolve",
                        lambda *a, **k: calls.append(1) or resolve(*a, **k))
    for _ in range(3):
        assert te_gemm.pick_block_shape(*shape) == heuristic
    assert calls == []  # memoized: no key built, no file read
    _store("te_gemm", shape, (8, 2), "float32")  # store drops the memo
    assert te_gemm.pick_block_shape(*shape) == (8, 2)
    assert len(calls) == 1
    tune.set_cache_path(str(tmp_path / "other.json"))  # so does a new path
    assert te_gemm.pick_block_shape(*shape) == heuristic
    tune.set_cache_path(cache_path)
    assert te_gemm.pick_block_shape(*shape) == (8, 2)
    tune.get_cache().clear()  # and clearing the entries
    assert te_gemm.pick_block_shape(*shape) == heuristic


def test_candidates_hold_the_heuristic_and_only_valid_choices(cache_path):
    for (m, n, k, dtype, epilogue), want in _PINNED_GEMM:
        if epilogue != "none":
            continue
        cands = te_gemm.block_shape_candidates(m, n, k, dtype)
        assert want in cands
        assert all(te_gemm._valid(c, n, dtype, "none") for c in cands)
    assert te_gemm.block_shape_candidates(28672, 32, 288, torch.float32) == \
        [(b, c) for b in (8, 16, 32) for c in (1, 2, 4)]
    assert mha.cluster_candidates(16, 256, 256, 64, True) == \
        [(1,), (2,), (4,)]
    assert mha.cluster_candidates(32, 64, 64, 16, False) == [(1,)]
    assert ldpc.segment_candidates(_CODE) == [(8,), (16,), (0,)]
    assert ldpc.segment_candidates(coding.make_code("r12", z=384)) == [(0,)]
    assert rx_fused.subcarrier_tile_candidates(False, 1, 1, 2) == \
        [(8,), (16,), (32,)]
    assert rx_fused.subcarrier_tile_candidates(False, 4, 4, 2) == [(16,)]
    assert rx_fused.subcarrier_tile_candidates(True, 1, 1, 2) == \
        [(8,), (16,), (32,)]  # one stream: the joint kernel's route
    assert rx_fused.threads_per_output_candidates(16) == [(1,), (2,)]
    assert rx_fused.threads_per_output_candidates(17) == [(1,)]


def test_explicit_impossible_choice_raises_on_cpu():
    """An explicit launch choice the kernel has no instance for is an
    error on the CPU as on the card, never ignored."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(64, 32, generator=g), torch.randn(32, 16, generator=g)
    te_gemm.te_gemm(x, w, choice=(16, 2))  # valid: the twin runs
    for bad in ((12, 2), (16, 0), (16,)):
        with pytest.raises(ValueError, match="launch choice"):
            te_gemm.te_gemm(x, w, choice=bad)
    with pytest.raises(ValueError, match="launch choice"):
        te_gemm.te_gemm_quant(x, w, choice=(48,))
    with pytest.raises(ValueError, match="launch choice"):
        te_gemm.te_gemm_quant(x, w, epilogue="softmax", choice=(8,))
    q = torch.randn(2, 64, 16, generator=g)
    with pytest.raises(ValueError, match="launch choice"):
        mha.mha(q, q, q, choice=(2,))  # one key tile
    y = torch.zeros(1, 14, 64, 4, dtype=torch.complex64)
    h = torch.zeros(1, 64, 4, 4, dtype=torch.complex64)
    with pytest.raises(ValueError, match="launch choice"):
        rx_fused.mmse_detect_demap(y, h, torch.tensor(0.1),
                                   ofdm.make_modem("qam16"), choice=(8,))
    with pytest.raises(ValueError, match="launch choice"):
        rx_fused.ls_che(torch.zeros(8, 14, 64, 4, dtype=torch.complex64),
                        (2, 11), 2, torch.zeros(1, 32, 64,
                                                dtype=torch.complex64),
                        choice=(2,))
    with pytest.raises(ValueError, match="launch choice"):
        ldpc.ldpc_decode(torch.zeros(2, _CODE.n_mother), _CODE, choice=(4,))


# -- the tuners ---------------------------------------------------------------

def test_energy_objective_picks_by_modeled_joules(tmp_path, monkeypatch):
    cache = tune.TuneCache(str(tmp_path / "tune.json"))
    times = {(1,): 10.0, (2,): 12.0}
    monkeypatch.setattr(tune, "_median_us",
                        lambda fn, iters=3, cuda=False: times[fn()])
    run = lambda c: c
    joules = lambda c, us: 1.0 if c == (1,) else 0.5
    kw = dict(cache=cache, backend="cpu")
    assert tune.autotune("op", (4,), [(1,), (2,)], run, **kw) == (1,)
    assert tune.autotune("op", (4,), [(1,), (2,)], run, energy_fn=joules,
                         objective="energy", **kw) == (2,)
    # the two objectives persist side by side
    assert cache.lookup(tune.cache_key("op", (4,), backend="cpu")) == (1,)
    assert cache.lookup(tune.cache_key("op", (4,), backend="cpu",
                                       objective="energy")) == (2,)
    with pytest.raises(ValueError, match="energy_fn"):
        tune.autotune("op", (4,), [(1,)], run, objective="energy", **kw)
    with pytest.raises(ValueError, match="no launch candidates"):
        tune.autotune("op", (4,), [], run, **kw)


def test_gemm_energy_prices_the_port_s_streams():
    """X is re-read once per column slab and W once per persistent
    block: at equal time a wider slab moves fewer bytes, more blocks
    more; the time's static power adds on top."""
    j = tune.gemm_energy_fn(28672, 32, 288, "fp32")
    assert j((32, 2), 10.0) < j((16, 2), 10.0) < j((8, 2), 10.0)
    assert j((8, 1), 10.0) < j((8, 4), 10.0)
    assert j((32, 2), 20.0) - j((32, 2), 10.0) == pytest.approx(
        0.6 * 10e-6)
    jq = tune.gemm_energy_fn(256, 256, 256, "int8")
    assert jq((64,), 5.0) < tune.gemm_energy_fn(256, 256, 256, "fp32")(
        (64, 2), 5.0)


def test_autotune_energy_objective_roundtrip(cache_path):
    best = tune.autotune_gemm(256, 256, 256, torch.int8, iters=1,
                              objective="energy", device="cpu")
    key = tune.cache_key("te_gemm", (256, 256, 256), "int8", backend="cpu",
                         objective="energy")
    assert tune.get_cache().lookup(key) == tuple(best)
    assert best in [(b,) for b in te_gemm.QUANT_SLABS]


def test_autotune_on_cpu_persists_each_winner(cache_path):
    """Every per-op tuner on CPU tensors (the twins timed) persists its
    winner under the reference's op and shape and the ``cpu`` backend,
    where the card's pickers (``cuda``) do not read it."""
    modem = ofdm.make_modem("qam16")
    runs = [
        (lambda: tune.autotune_gemm(64, 32, 48, torch.float32, iters=1,
                                    device="cpu"),
         "te_gemm", (64, 32, 48), "float32"),
        (lambda: tune.autotune_mha(2, 64, 128, 16, causal=False, iters=1,
                                   device="cpu"),
         "mha", (2, 64, 128, 16), ""),
        (lambda: tune.autotune_rx_detect(1, 14, 64, 1, 1, modem, iters=1,
                                         device="cpu"),
         "rx_detect_demap", (14, 64, 1, 1, 4), ""),
        (lambda: tune.autotune_rx_sic(1, 14, 32, 2, 2, modem, iters=1,
                                      device="cpu"),
         "rx_sic_demap", (14, 32, 2, 2, 4), ""),
        (lambda: tune.autotune_ldpc(4, _CODE, max_iters=4, iters=1,
                                    device="cpu"),
         "ldpc_decode", (12, 12, 32, 4), ""),
        (lambda: tune.autotune_rx_ls_che(2, 14, 64, 2, 2, 2, iters=1,
                                         device="cpu"),
         "rx_ls_che", (64, 2, 2, 16), ""),
    ]
    for run, op, shape, extra in runs:
        choice = tuple(run())
        assert tune.get_cache().lookup(tune.cache_key(
            op, shape, extra, backend="cpu")) == choice
        assert tune.cached_choice(op, shape, extra, backend="cuda") is None
    assert json.load(open(cache_path))["version"] == 1


def test_autotune_reports_each_candidate_s_time(cache_path):
    timings = {}
    choice = tune.autotune_ldpc(4, _CODE, max_iters=4, iters=1,
                                device="cpu", timings=timings)
    assert set(timings) == set(ldpc.segment_candidates(_CODE))
    assert choice == min(timings, key=timings.get)
    assert all(np.isfinite(us) and us > 0 for us in timings.values())


def test_ldpc_tuner_draws_codewords_that_iterate():
    """The LDPC tuner's LLRs (r12 at +3 dB) make the decoder sweep: more
    than one iteration on most codewords, where the reference's own draw
    (amplitude 3, noise 0.7) converges at the entry syndrome check on
    every one, which would time only the exit path."""
    llr = tune.ldpc_tune_llrs(216, _CODE, "cpu")
    assert tuple(llr.shape) == (216, _CODE.n_mother)
    _, iters = ldpc.ldpc_decode(llr, _CODE)
    assert float((iters > 1).float().mean()) > 0.9
    gen = torch.Generator().manual_seed(0)
    bits = (torch.rand((216, _CODE.k), generator=gen) < 0.5).to(torch.int32)
    cw = coding.encode(_CODE, bits)
    easy = coding.derate_match(_CODE, ((2.0 * cw - 1.0) * 3.0 + torch.randn(
        cw.shape, generator=gen) * 0.7)[..., : _CODE.e_bits])
    assert int(ldpc.ldpc_decode(easy, _CODE)[1].max()) == 0
