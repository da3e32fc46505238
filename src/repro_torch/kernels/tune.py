"""Launch-choice autotuner for the Hopper kernels (port of
:mod:`repro.kernels.tune`).

Each kernel's wrapper picks its launch shape through a ``pick_*``
function beside it (:func:`repro_torch.kernels.te_gemm.pick_block_shape`,
:func:`~repro_torch.kernels.mha.pick_cluster`,
:func:`~repro_torch.kernels.rx_fused.pick_subcarrier_tile`,
:func:`~repro_torch.kernels.rx_fused.pick_threads_per_output`,
:func:`~repro_torch.kernels.ldpc.pick_segment`): a winner this module
measured and persisted for (op, shape, dtype, ``cuda``), when the kernel
has an instance for it at the call's shape, else a static heuristic (the
rule the kernels' host code applied before it took the choice as an
argument).  The choices are the Hopper kernels' own: ``te_gemm``'s column
slab and persistent blocks an SM, ``te_gemm_quant``'s slab, ``mha``'s
key-split cluster, detect + demap's subcarriers a block, the LDPC
decoders' lanes a lifted row, ``ls_che``'s threads an output.  The
reference's TPU block shapes have no counterpart here.

Cache entries are keyed by backend: ``cuda`` for a run on CUDA tensors,
``cpu`` for one on CPU tensors (which times the plain twins; the
knobs mean nothing to them).  The reference writes ``cpu`` / ``tpu`` /
``gpu``, so one file can hold both packages' entries.

Cache file format (JSON), the reference's::

    {
      "version": 1,
      "entries": {
        "te_gemm|28672x32x288|float32|cuda": {
          "choice": [16, 2],
          "us": 18.3,
          "n_candidates": 9
        }
      }
    }

The default path is ``~/.cache/repro-tensorpool/tune.json``; override with
the ``REPRO_TUNE_CACHE`` environment variable or :func:`set_cache_path`.
Lookups are tolerant: a missing or corrupt cache reads as empty, and a
stale entry the kernel has no instance for at the call's shape is ignored
by the picker.

The pickers run on every eager call (training's 18 ``te_gemm`` calls a
step), so a picker's answer is memoized per (op, shape, extra) in the
process (:func:`picked`); :meth:`TuneCache.store`, :meth:`TuneCache.clear`
and :func:`set_cache_path` drop the memo.
A step the executable registry captures as a CUDA graph resolves its
choices at capture, so a winner stored later takes effect at the next
capture.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence

_ENV_VAR = "REPRO_TUNE_CACHE"
_ORIG_ENV = os.environ.get(_ENV_VAR)  # restored by set_cache_path(None)
_VERSION = 1


def repro_cache_path(env_var: str, *leaf: str) -> str:
    """Resolve a cache location under the shared ``REPRO_*`` convention.

    The environment variable wins outright (tests point it at tmp dirs);
    otherwise the cache lives under ``~/.cache/repro-tensorpool/<leaf...>``.
    """
    return os.environ.get(
        env_var,
        os.path.join(
            os.path.expanduser("~"), ".cache", "repro-tensorpool", *leaf
        ),
    )


def default_cache_path() -> str:
    return repro_cache_path(_ENV_VAR, "tune.json")


def default_backend() -> str:
    """``cuda`` where a card is present, else ``cpu``."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_of(device) -> str:
    """The key's backend for tensors on ``device``."""
    import torch

    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def cache_key(op: str, shape: Sequence[int], extra: str = "",
              backend: Optional[str] = None,
              objective: str = "latency") -> str:
    backend = backend or default_backend()
    dims = "x".join(str(int(d)) for d in shape)
    obj = "" if objective == "latency" else f"obj-{objective}"
    return "|".join(p for p in (op, dims, extra, obj, backend) if p)


# the pickers' memo: (op, shape, extra, ...) -> choice, valid while the
# process-wide cache's entries and path are unchanged
_PICKED: dict = {}


def _forget_picks() -> None:
    _PICKED.clear()


class TuneCache:
    """Persistent (op, shape, dtype, backend) -> launch-choice winners."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._entries: Optional[dict] = None  # lazy

    # -- persistence ------------------------------------------------------
    def _load(self) -> dict:
        if self._entries is None:
            self._entries = {}
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if isinstance(data, dict) and data.get("version") == _VERSION:
                    self._entries = dict(data.get("entries", {}))
            except (OSError, ValueError):
                pass  # missing/corrupt cache == empty cache
        return self._entries

    def save(self):
        """Atomically persist the cache: write a sibling tmp file and
        ``os.replace`` it over the target, so an interrupted or
        concurrent run can never leave a truncated cache behind."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        payload = {"version": _VERSION, "entries": self._load()}
        tmp = os.path.join(d, f".{os.path.basename(self.path)}.{os.getpid()}.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    # -- access -----------------------------------------------------------
    def lookup(self, key: str) -> Optional[tuple]:
        ent = self._load().get(key)
        if not ent or "choice" not in ent:
            return None
        return tuple(ent["choice"])

    def store(self, key: str, choice: Sequence[int], us: float,
              n_candidates: int = 0, save: bool = True):
        self._load()[key] = {
            "choice": [int(c) for c in choice],
            "us": round(float(us), 1),
            "n_candidates": int(n_candidates),
        }
        _forget_picks()
        if save:
            self.save()

    def clear(self):
        self._entries = {}
        _forget_picks()


_CACHE: Optional[TuneCache] = None


def get_cache() -> TuneCache:
    global _CACHE
    if _CACHE is None or _CACHE.path != default_cache_path():
        _CACHE = TuneCache()
        _forget_picks()  # answers read from another file
    return _CACHE


def set_cache_path(path: Optional[str]):
    """Point the process-wide cache at ``path``.

    ``None`` restores the environment as it was at import time (an
    operator-set ``REPRO_TUNE_CACHE`` survives a set/reset cycle).
    """
    global _CACHE
    if path is None:
        if _ORIG_ENV is None:
            os.environ.pop(_ENV_VAR, None)
        else:
            os.environ[_ENV_VAR] = _ORIG_ENV
    else:
        os.environ[_ENV_VAR] = path
    _CACHE = None
    _forget_picks()


def cached_choice(op: str, shape: Sequence[int], extra: str = "",
                  objective: str = "latency",
                  backend: Optional[str] = None) -> Optional[tuple]:
    """The persisted winner for (op, shape, extra) on ``backend`` (default
    :func:`default_backend`), if any."""
    return get_cache().lookup(cache_key(op, shape, extra, backend=backend,
                                        objective=objective))


def picked(key: tuple, pick: Callable[[], tuple]) -> tuple:
    """``pick()``'s answer for ``key``, memoized in the process (a
    picker's key holds everything its answer depends on), so a wrapper's
    call neither builds a cache key nor reads the environment or the
    file: point the process at another cache with :func:`set_cache_path`."""
    choice = _PICKED.get(key)
    if choice is None:
        choice = _PICKED[key] = tuple(int(c) for c in pick())
    return choice


def as_choice(choice, length: int, op: str, form: str) -> tuple:
    """An explicit launch choice as a tuple of ``length`` ints; raise when
    it has another length (the kernel refuses a value it has no instance
    for)."""
    if len(choice) != length:
        raise ValueError(f"{op}: launch choice {tuple(choice)} is not {form}")
    return tuple(int(c) for c in choice)


def resolve(op: str, shape: Sequence[int], extra: str,
            valid: Callable[[tuple], bool],
            heuristic: Callable[[], tuple],
            objectives: Sequence[str] = ("latency",)) -> tuple:
    """The ``cuda`` winner for (op, shape, extra) under the first of
    ``objectives`` that has one, when ``valid`` (the kernel has an
    instance for it at the call's shape); else ``heuristic()``."""
    for objective in objectives:
        cached = cached_choice(op, shape, extra, objective=objective,
                               backend="cuda")
        if cached is not None:
            return cached if valid(cached) else tuple(heuristic())
    return tuple(heuristic())


# ---------------------------------------------------------------------------
# timing + generic search
# ---------------------------------------------------------------------------

# cycles the card spins before each timed call (~2 ms at the H100's
# 1.98 GHz), longer than any wrapper's host enqueue
_HOLD_CYCLES = 4_000_000


def _median_us(fn: Callable, warmup: int = 1, iters: int = 3,
               cuda: bool = False) -> float:
    """Median microseconds of ``fn`` over ``iters`` calls after
    ``warmup``: CUDA events on the current stream around each call when
    ``cuda``, else the host clock.  On the card each call is enqueued
    behind a spin (``torch.cuda._sleep``), so the events bracket the
    call's device work and not the host's enqueue, which would otherwise
    set the time of every small kernel alike."""
    if cuda:
        import torch

        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def autotune(op: str, shape: Sequence[int], candidates: Sequence[tuple],
             run: Callable[[tuple], object], *, extra: str = "",
             iters: int = 3, cache: Optional[TuneCache] = None,
             objective: str = "latency",
             energy_fn: Optional[Callable[[tuple, float], float]] = None,
             backend: Optional[str] = None,
             timings: Optional[dict] = None) -> tuple:
    """Measure ``run(candidate)`` for every candidate, persist + return the
    winner under ``backend`` (default :func:`default_backend`; on ``cuda``
    the calls are timed with CUDA events).

    ``objective="latency"`` picks the minimum median microseconds.
    ``objective="energy"`` picks the minimum *modeled joules per call*:
    ``energy_fn(candidate, us)`` prices the candidate's dynamic energy
    (its launch shape decides the HBM -> shared-memory stream traffic)
    plus the static power burned over the measured time.  The two
    objectives persist under distinct cache keys.  ``timings``, when
    given, receives each candidate's median microseconds.
    """
    if not candidates:
        raise ValueError(f"no launch candidates for {op} {tuple(shape)}")
    if objective not in ("latency", "energy"):
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "energy" and energy_fn is None:
        raise ValueError("objective='energy' needs energy_fn")
    backend = backend or default_backend()
    cache = cache or get_cache()
    best = None
    for cand in candidates:
        cand = tuple(cand)
        us = _median_us(lambda: run(cand), iters=iters,
                        cuda=backend == "cuda")
        if timings is not None:
            timings[cand] = us
        score = us if objective == "latency" else energy_fn(cand, us)
        if best is None or score < best[0]:
            best = (score, us, cand)
    _, us, choice = best
    cache.store(cache_key(op, shape, extra, backend=backend,
                          objective=objective), choice, us,
                n_candidates=len(candidates))
    return choice


# ---------------------------------------------------------------------------
# per-op tuners (lazy kernel imports keep this module dependency-free)
# ---------------------------------------------------------------------------

def _divisor_cands(n: int, cands: Sequence[int]) -> list[int]:
    out = [c for c in cands if c <= n and n % c == 0]
    return out or [n]


def gemm_energy_fn(m: int, n: int, k: int, precision: str,
                   out_bytes: int = 4, sms: int = 132
                   ) -> Callable[[tuple, float], float]:
    """Modeled joules/call for a TE GEMM launch choice: MAC energy at the
    dtype's pJ/MAC (choice-invariant) + the bytes the port's tile streams
    priced at the DMA pJ/byte + static power over the measured time.  The
    bytes: each column slab of ``bn`` re-reads X (ceil(n / bn) passes),
    W is read once per persistent block (a ``bn`` x K slab each; the grid
    is min(tiles, blocks an SM x ``sms``), ``te_gemm``'s choice (bn,
    per_sm), ``te_gemm_quant``'s (bn,) at its fixed 2 blocks an SM), and
    Z is written once."""
    from repro_torch.analysis import costmodel as _cm
    from repro_torch.kernels import quant as _q

    nbytes = _q.itemsize(precision)
    pj_mac = _cm.PJ_PER_MAC[_q.resolve_precision(precision)]

    def joules(cand: tuple, us: float) -> float:
        bn = cand[0]
        per_sm = cand[1] if len(cand) > 1 else 2
        slabs = -(-n // bn)
        blocks = min(-(-m // 64) * slabs, per_sm * sms)
        bytes_moved = (nbytes * (m * k * slabs + blocks * k * bn)
                       + out_bytes * m * n)
        dyn_pj = m * n * k * pj_mac + bytes_moved * _cm.PJ_PER_BYTE_DMA
        return dyn_pj * 1e-12 + _cm.STATIC_W * us * 1e-6

    return joules


def _device(device):
    import torch

    return torch.device("cuda" if device is None else device)


def _gen(device):
    import torch

    return torch.Generator(device=device).manual_seed(0)


def _cplx(gen, shape, device):
    import torch

    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im)


def _sms(device) -> int:
    import torch

    from repro_torch.kernels import _build

    if device.type != "cuda":
        return 132  # the H100 SXM's, for the energy model on the CPU
    return _build.sm_count(device.index if device.index is not None
                           else torch.cuda.current_device())


def autotune_gemm(m: int, n: int, k: int, dtype=None, *,
                  iters: int = 3, cache: Optional[TuneCache] = None,
                  objective: str = "latency", device=None,
                  timings: Optional[dict] = None) -> tuple:
    """Tune ``te_gemm``'s (bn, per_sm) at (m, n, k) and persist it.

    Keys on the dtype *name* (``float32`` / ``bfloat16`` / ``int8`` /
    ``float8_e4m3fn``), never on itemsize — the 1-byte dtypes would
    collide.  Quantized dtypes run ``te_gemm_quant`` (its slab (bn,)) so
    the winner reflects the dequant epilogue.
    """
    import torch

    from repro_torch.kernels import quant as _q
    from repro_torch.kernels import te_gemm as _te

    dev = _device(device)
    dtype = dtype or torch.bfloat16
    precision = _q.precision_of_dtype(dtype)
    gen = _gen(dev)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    if _q.is_quantized(precision):
        run = lambda c: _te.te_gemm_quant(x, w, precision=precision,
                                          choice=c)
    else:
        x, w = x.to(dtype), w.to(dtype)
        run = lambda c: _te.te_gemm(x, w, choice=c)
    return autotune(
        "te_gemm", (m, n, k), _te.block_shape_candidates(m, n, k, dtype),
        run, extra=_q.dtype_name(dtype), iters=iters, cache=cache,
        objective=objective, backend=backend_of(dev), timings=timings,
        energy_fn=gemm_energy_fn(m, n, k, precision, sms=_sms(dev)),
    )


def autotune_mha(bh: int, sq: int, sk: int, d: int, *, causal: bool = True,
                 iters: int = 3, cache: Optional[TuneCache] = None,
                 device=None, timings: Optional[dict] = None) -> tuple:
    """Tune ``mha``'s key-split cluster (cs,) and persist it."""
    import torch

    from repro_torch.kernels import mha as _mha

    dev = _device(device)
    gen = _gen(dev)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
               for s in (sq, sk, sk))
    return autotune(
        "mha", (bh, sq, sk, d),
        _mha.cluster_candidates(bh, sq, sk, d, causal=causal),
        lambda c: _mha.mha(q, k, v, causal=causal, choice=c),
        iters=iters, cache=cache, backend=backend_of(dev), timings=timings,
    )


def _demap_tuner(op: str, sic: bool, batch: int, n_sym: int, n_sc: int,
                 n_rx: int, n_tx: int, modem, iters: int,
                 cache: Optional[TuneCache], device,
                 timings: Optional[dict]) -> tuple:
    import torch

    from repro_torch.kernels import rx_fused as _rx

    dev = _device(device)
    gen = _gen(dev)
    y = _cplx(gen, (batch, n_sym, n_sc, n_rx), dev)
    h = _cplx(gen, (batch, n_sc, n_rx, n_tx), dev)
    nv = torch.tensor(0.1, dtype=torch.float32, device=dev)
    kernel = _rx.sic_detect_demap if sic else _rx.mmse_detect_demap
    return autotune(
        op, (n_sym, n_sc, n_rx, n_tx, len(modem.levels)),
        _rx.subcarrier_tile_candidates(sic, n_rx, n_tx,
                                       modem.bits_per_symbol // 2),
        lambda c: kernel(y, h, nv, modem, choice=c)[2],
        iters=iters, cache=cache, backend=backend_of(dev), timings=timings,
    )


def autotune_rx_detect(batch: int, n_sym: int, n_sc: int, n_rx: int,
                       n_tx: int, modem, *, iters: int = 3,
                       cache: Optional[TuneCache] = None, device=None,
                       timings: Optional[dict] = None) -> tuple:
    """Tune the subcarriers a block (sct,) of the fused detect+demap
    kernel."""
    return _demap_tuner("rx_detect_demap", False, batch, n_sym, n_sc, n_rx,
                        n_tx, modem, iters, cache, device, timings)


def autotune_rx_sic(batch: int, n_sym: int, n_sc: int, n_rx: int,
                    n_tx: int, modem, *, iters: int = 3,
                    cache: Optional[TuneCache] = None, device=None,
                    timings: Optional[dict] = None) -> tuple:
    """Tune the subcarriers a block (sct,) of the fused SIC detect+demap
    kernel.

    Tuned separately from ``rx_detect_demap``: the SIC kernel factors
    n_tx shrinking systems per subcarrier, so its best tile may differ
    from the joint kernel's.
    """
    return _demap_tuner("rx_sic_demap", True, batch, n_sym, n_sc, n_rx,
                        n_tx, modem, iters, cache, device, timings)


# the SNR (dB) of the codewords the LDPC tuner decodes: BPSK over AWGN at
# the main path's r12 point, where the decoder sweeps several times
LDPC_TUNE_SNR_DB = 3.0


def ldpc_tune_llrs(batch: int, code, device=None):
    """(batch, n_mother) channel LLRs of random codewords sent as BPSK
    over AWGN at :data:`LDPC_TUNE_SNR_DB`, rate-matched and de-rate-matched
    as the receiver sees them.  The reference's tuner draws amplitude-3
    symbols with noise 0.7 (about +12.6 dB), which the decoder's entry
    syndrome check passes at once; a candidate timed there is timed on
    its exit path only, so the port draws codewords that iterate."""
    import torch

    from repro_torch.phy import coding as _coding

    dev = _device(device)
    gen = _gen(dev)
    bits = (torch.rand((batch, code.k), generator=gen, device=dev)
            < 0.5).to(torch.int32)
    tx = _coding.rate_match(code, _coding.encode(code, bits)).float()
    s2 = 10.0 ** (-LDPC_TUNE_SNR_DB / 10.0)
    y = (2.0 * tx - 1.0) + s2 ** 0.5 * torch.randn(
        tx.shape, generator=gen, device=dev)
    return _coding.derate_match(code, 2.0 * y / s2).contiguous()


def autotune_ldpc(batch: int, code, *, max_iters: int = 12,
                  iters: int = 3, cache: Optional[TuneCache] = None,
                  device=None, timings: Optional[dict] = None) -> tuple:
    """Tune the LDPC decoders' lanes a lifted row (seg,) on
    :func:`ldpc_tune_llrs` and persist it under the reference's key (both
    datapaths read the winner, as the reference's share one key)."""
    from repro_torch.kernels import ldpc as _ldpc

    dev = _device(device)
    llr = ldpc_tune_llrs(batch, code, dev)
    return autotune(
        "ldpc_decode", (code.k_b, code.m_b, code.z, max_iters),
        _ldpc.segment_candidates(code),
        lambda c: _ldpc.ldpc_decode(llr, code, max_iters=max_iters,
                                    choice=c)[0],
        iters=iters, cache=cache, backend=backend_of(dev), timings=timings,
    )


def autotune_rx_ls_che(batch: int, n_sym: int, n_sc: int, n_rx: int,
                       n_tx: int, pilot_stride: int,
                       pilot_symbols: tuple = (2, 11), *, iters: int = 3,
                       cache: Optional[TuneCache] = None, device=None,
                       timings: Optional[dict] = None) -> tuple:
    """Tune the fused LS-CHE kernel's threads an output (tpo,)."""
    import numpy as np
    import torch

    from repro_torch.kernels import rx_fused as _rx

    dev = _device(device)
    gen = _gen(dev)
    y = _cplx(gen, (batch, n_sym, n_sc, n_rx), dev)
    seq = np.exp(1j * (np.pi / 4 + np.pi / 2 * (np.arange(n_sc) % 4)))
    op = torch.from_numpy(
        _rx.make_ls_interp_operator(n_sc, n_tx, pilot_stride, seq)).to(dev)
    return autotune(
        "rx_ls_che", (n_sc, n_rx, n_tx, op.shape[1]),
        _rx.threads_per_output_candidates(batch * n_rx),
        lambda c: _rx.ls_che(y, pilot_symbols, pilot_stride, op, choice=c),
        iters=iters, cache=cache, backend=backend_of(dev), timings=timings,
    )
